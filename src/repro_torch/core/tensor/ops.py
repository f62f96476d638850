"""Public tensor API (``repro.core.tensor.ops``): primitive dispatch +
composed (derived) operators.

Mirrors numpy at a high level (paper §4.1.1) while routing every
primitive through the session's :class:`TensorBackend`.  Derived ops are
*compositions* of primitives, exactly as in the reference (``relu`` is
``maximum(x, 0)``), so a backend needs to implement only the small
primitive surface.

Creation functions take the ``device`` to create on and, like every
entry point of the port, default to the card; derived ops create on
their input's device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.runtime import current_session

from .dispatch import current_backend

# --------------------------------------------------------------------------
# primitive dispatchers
# --------------------------------------------------------------------------


def full(shape, fill_value, dtype=torch.float32, device="cuda"):
    return current_backend().full(shape, fill_value, dtype, device)


def zeros(shape, dtype=torch.float32, device="cuda"):
    return current_backend().full(shape, 0, dtype, device)


def ones(shape, dtype=torch.float32, device="cuda"):
    return current_backend().full(shape, 1, dtype, device)


def arange(start, stop=None, step=1, dtype=torch.int32, device="cuda"):
    if stop is None:
        start, stop = 0, start
    return current_backend().arange(start, stop, step, dtype, device)


def iota(dtype, shape, dimension, device="cuda"):
    return current_backend().iota(dtype, shape, dimension, device)


def random_uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
                   device="cuda"):
    return current_backend().random_uniform(key, shape, dtype, minval, maxval,
                                            device)


def random_normal(key, shape, dtype=torch.float32, device="cuda"):
    return current_backend().random_normal(key, shape, dtype, device)


def _unary(name):
    def op(x):
        return getattr(current_backend(), name)(x)
    op.__name__ = name
    return op


def _binary(name):
    def op(lhs, rhs):
        return getattr(current_backend(), name)(lhs, rhs)
    op.__name__ = name
    return op


neg = _unary("neg")
exp = _unary("exp")
log = _unary("log")
sin = _unary("sin")
cos = _unary("cos")
tanh = _unary("tanh")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
abs = _unary("abs")  # noqa: A001 - numpy-mirroring API
sign = _unary("sign")
floor = _unary("floor")
erf = _unary("erf")
logical_not = _unary("logical_not")
isnan = _unary("isnan")

add = _binary("add")
sub = _binary("sub")
mul = _binary("mul")
div = _binary("div")
pow = _binary("pow")  # noqa: A001
maximum = _binary("maximum")
minimum = _binary("minimum")
mod = _binary("mod")
eq = _binary("eq")
ne = _binary("ne")
lt = _binary("lt")
le = _binary("le")
gt = _binary("gt")
ge = _binary("ge")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")


def matmul(lhs, rhs):
    """Session kernel-override point: ``session(kernels={"matmul": fn})``
    injects a custom contraction ahead of backend dispatch."""
    fn = current_session().kernels.matmul
    if fn is not None:
        return fn(lhs, rhs)
    return current_backend().matmul(lhs, rhs)


def sum(x, axis=None, keepdims=False):  # noqa: A001
    return current_backend().sum(x, axis, keepdims)


def max(x, axis=None, keepdims=False):  # noqa: A001
    return current_backend().max(x, axis, keepdims)


def min(x, axis=None, keepdims=False):  # noqa: A001
    return current_backend().min(x, axis, keepdims)


def prod(x, axis=None, keepdims=False):
    return current_backend().prod(x, axis, keepdims)


def argmax(x, axis=None):
    return current_backend().argmax(x, axis)


def cumsum(x, axis=-1):
    return current_backend().cumsum(x, axis)


def reshape(x, shape):
    return current_backend().reshape(x, shape)


def transpose(x, axes=None):
    return current_backend().transpose(x, axes)


def broadcast_to(x, shape):
    return current_backend().broadcast_to(x, shape)


def concatenate(xs, axis=0):
    return current_backend().concatenate(xs, axis)


def slice(x, start, limit):  # noqa: A001
    return current_backend().slice(x, start, limit)


def dynamic_slice(x, start_indices, slice_sizes):
    return current_backend().dynamic_slice(x, start_indices, slice_sizes)


def dynamic_update_slice(x, update, start_indices):
    return current_backend().dynamic_update_slice(x, update, start_indices)


def pad(x, pad_width, value=0.0):
    return current_backend().pad(x, pad_width, value)


def where(cond, x, y):
    return current_backend().where(cond, x, y)


def take(x, indices, axis=0):
    return current_backend().take(x, indices, axis)


def take_along_axis(x, indices, axis):
    return current_backend().take_along_axis(x, indices, axis)


def scatter_add(x, indices, updates, axis=0):
    return current_backend().scatter_add(x, indices, updates, axis)


def flip(x, axis):
    return current_backend().flip(x, axis)


def sort(x, axis=-1):
    return current_backend().sort(x, axis)


def top_k(x, k):
    return current_backend().top_k(x, k)


def astype(x, dtype):
    return current_backend().astype(x, dtype)


def stop_gradient(x):
    return current_backend().stop_gradient(x)


def dot_general(lhs, rhs, dimension_numbers, preferred_element_type=None):
    return current_backend().dot_general(
        lhs, rhs, dimension_numbers, preferred_element_type)


def conv2d(x, w, stride=(1, 1), padding="SAME"):
    return current_backend().conv2d(x, w, stride, padding)


def materialize(x):
    """Force deferred value(s); a list/tuple materializes jointly on
    backends that support it (eager backends return the values)."""
    backend = current_backend()
    if isinstance(x, (list, tuple)):
        many = getattr(backend, "materialize_many", None)
        vals = many(x) if many is not None \
            else [backend.materialize(v) for v in x]
        if hasattr(x, "_fields"):         # namedtuple: positional fields
            return type(x)(*vals)
        return type(x)(vals)
    return backend.materialize(x)


# --------------------------------------------------------------------------
# derived operators (composition only: no new backend requirements)
# --------------------------------------------------------------------------


def relu(x):
    """The paper's canonical composition example: relu = max(x, 0)."""
    return maximum(x, zeros_like(x))


def zeros_like(x):
    return full(x.shape, 0, x.dtype, x.device)


def ones_like(x):
    return full(x.shape, 1, x.dtype, x.device)


def full_like(x, v):
    return full(x.shape, v, x.dtype, x.device)


def sigmoid(x):
    return div(ones_like(x), add(ones_like(x), exp(neg(x))))


def silu(x):
    return mul(x, sigmoid(x))


def gelu(x):
    # exact gelu via erf
    half = full_like(x, 0.5)
    one = ones_like(x)
    inv_sqrt2 = full_like(x, 1.0 / math.sqrt(2.0))
    return mul(mul(half, x), add(one, erf(mul(x, inv_sqrt2))))


def softplus(x):
    return log(add(ones_like(x), exp(neg(abs(x))))) + maximum(x, zeros_like(x))


def mean(x, axis=None, keepdims=False):
    total = sum(x, axis=axis, keepdims=keepdims)
    if axis is None:
        n = math.prod(x.shape) if x.shape else 1
    elif isinstance(axis, int):
        n = x.shape[axis]
    else:
        n = math.prod(x.shape[a] for a in axis)
    return div(total, full_like(total, n))


def var(x, axis=None, keepdims=False):
    mu = mean(x, axis=axis, keepdims=True)
    d = sub(x, mu)
    v = mean(mul(d, d), axis=axis, keepdims=keepdims)
    return v


def softmax(x, axis=-1):
    m = max(x, axis=axis, keepdims=True)
    e = exp(sub(x, stop_gradient(m)))
    return div(e, sum(e, axis=axis, keepdims=True))


def log_softmax(x, axis=-1):
    m = stop_gradient(max(x, axis=axis, keepdims=True))
    shifted = sub(x, m)
    lse = log(sum(exp(shifted), axis=axis, keepdims=True))
    return sub(shifted, lse)


def logsumexp(x, axis=-1, keepdims=False):
    m = stop_gradient(max(x, axis=axis, keepdims=True))
    out = add(log(sum(exp(sub(x, m)), axis=axis, keepdims=keepdims)),
              m if keepdims else reshape(m, max(x, axis=axis, keepdims=keepdims).shape))
    return out


def one_hot(indices, num_classes, dtype=torch.float32):
    iota_ = iota(torch.int32, tuple(indices.shape) + (num_classes,),
                 len(indices.shape), indices.device)
    idx = broadcast_to(reshape(indices, tuple(indices.shape) + (1,)),
                       tuple(indices.shape) + (num_classes,))
    return astype(eq(iota_, idx), dtype)


def rms_norm(x, weight, eps=1e-6):
    ms = mean(mul(x, x), axis=-1, keepdims=True)
    inv = rsqrt(add(ms, full_like(ms, eps)))
    return mul(mul(x, inv), weight)


def layer_norm(x, weight, bias, eps=1e-5):
    mu = mean(x, axis=-1, keepdims=True)
    v = var(x, axis=-1, keepdims=True)
    xhat = mul(sub(x, mu), rsqrt(add(v, full_like(v, eps))))
    return add(mul(xhat, weight), bias)


def dropout_mask(key, shape, rate, dtype=torch.float32, device="cuda"):
    keep = random_uniform(key, shape, torch.float32, 0.0, 1.0, device)
    keep = astype(ge(keep, full(shape, rate, torch.float32, device)), dtype)
    return div(keep, full(shape, 1.0 - rate, dtype, device))


def clip(x, lo, hi):
    return minimum(maximum(x, full_like(x, lo)), full_like(x, hi))


def square(x):
    return mul(x, x)
