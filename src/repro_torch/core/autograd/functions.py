"""Differentiable operators over Variables
(``repro.core.autograd.functions``).

Each function runs its forward through the *active tensor backend* (so a
backend swap reaches gradients too) and records a VJP closure onto the
tape.  Hot/simple VJPs are hand-written (compact, inspectable — the paper's
Listing 4 style); anything long-tail lifts through ``torch.func.vjp`` via
:func:`lift`, keeping the implementation deliberately small.

``torch.func`` cannot differentiate through a ctypes kernel, so a
function that reaches one never goes through :func:`lift`: ``matmul``,
the op the Hopper backend runs as a kernel, has an explicit VJP whose two
products dispatch through ``ops.matmul`` too.  The lifted functions here
(gelu, silu, layer_norm, rms_norm, conv2d, dot_general, getitem) compose
primitives that no shipped backend runs as a ctypes kernel.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..tensor import ops
from .variable import Variable, _as_variable, record


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _unbroadcast(grad, shape):
    """Sum ``grad`` down to ``shape`` (reverse of numpy broadcasting)."""
    if tuple(grad.shape) == tuple(shape):
        return grad
    extra = len(grad.shape) - len(shape)
    if extra > 0:
        grad = ops.sum(grad, axis=tuple(range(extra)), keepdims=False)
    axes = tuple(i for i, (g, s) in enumerate(zip(grad.shape, shape))
                 if s == 1 and g != 1)
    if axes:
        grad = ops.sum(grad, axis=axes, keepdims=True)
    return ops.reshape(grad, shape)


def lift(fn: Callable, name: str | None = None) -> Callable:
    """Lift a tensor-level function into a Variable op via
    ``torch.func.vjp`` (``fn`` must not reach a ctypes kernel)."""
    opname = name or getattr(fn, "__name__", "lifted")

    def wrapped(*args: Variable, **kwargs):
        vs = tuple(_as_variable(a) for a in args)
        datas = tuple(ops.materialize(v.data) for v in vs)
        out, vjp_fn = torch.func.vjp(lambda *xs: fn(*xs, **kwargs), *datas)
        return record(out, vs, vjp_fn, name=opname)

    wrapped.__name__ = opname
    return wrapped


# --------------------------------------------------------------------------
# arithmetic
# --------------------------------------------------------------------------

def add(a: Variable, b: Variable) -> Variable:
    a, b = _as_variable(a), _as_variable(b)
    out = ops.add(a.data, b.data)

    def vjp(g):
        return (_unbroadcast(g, a.shape), _unbroadcast(g, b.shape))

    return record(out, (a, b), vjp, "add")


def sub(a: Variable, b: Variable) -> Variable:
    a, b = _as_variable(a), _as_variable(b)
    out = ops.sub(a.data, b.data)

    def vjp(g):
        return (_unbroadcast(g, a.shape),
                _unbroadcast(ops.neg(g), b.shape))

    return record(out, (a, b), vjp, "sub")


def mul(a: Variable, b: Variable) -> Variable:
    a, b = _as_variable(a), _as_variable(b)
    out = ops.mul(a.data, b.data)
    ad, bd = a.data, b.data

    def vjp(g):
        return (_unbroadcast(ops.mul(g, bd), a.shape),
                _unbroadcast(ops.mul(g, ad), b.shape))

    return record(out, (a, b), vjp, "mul")


def div(a: Variable, b: Variable) -> Variable:
    a, b = _as_variable(a), _as_variable(b)
    out = ops.div(a.data, b.data)
    ad, bd = a.data, b.data

    def vjp(g):
        ga = ops.div(g, bd)
        gb = ops.neg(ops.div(ops.mul(g, ad), ops.mul(bd, bd)))
        return (_unbroadcast(ga, a.shape), _unbroadcast(gb, b.shape))

    return record(out, (a, b), vjp, "div")


def neg(a: Variable) -> Variable:
    a = _as_variable(a)
    return record(ops.neg(a.data), (a,), lambda g: (ops.neg(g),), "neg")


def exp(a: Variable) -> Variable:
    a = _as_variable(a)
    out = ops.exp(a.data)
    return record(out, (a,), lambda g: (ops.mul(g, out),), "exp")


def log(a: Variable) -> Variable:
    a = _as_variable(a)
    ad = a.data
    return record(ops.log(ad), (a,), lambda g: (ops.div(g, ad),), "log")


def tanh(a: Variable) -> Variable:
    a = _as_variable(a)
    out = ops.tanh(a.data)

    def vjp(g):
        return (ops.mul(g, ops.sub(ops.ones_like(out), ops.mul(out, out))),)

    return record(out, (a,), vjp, "tanh")


def sqrt(a: Variable) -> Variable:
    a = _as_variable(a)
    out = ops.sqrt(a.data)

    def vjp(g):
        return (ops.div(g, ops.mul(ops.full_like(out, 2.0), out)),)

    return record(out, (a,), vjp, "sqrt")


def maximum(a: Variable, b: Variable) -> Variable:
    a, b = _as_variable(a), _as_variable(b)
    ad, bd = a.data, b.data
    out = ops.maximum(ad, bd)

    def vjp(g):
        mask = ops.astype(ops.ge(ad, bd), g.dtype)
        return (_unbroadcast(ops.mul(g, mask), a.shape),
                _unbroadcast(ops.mul(g, ops.sub(ops.ones_like(mask), mask)),
                             b.shape))

    return record(out, (a, b), vjp, "maximum")


def relu(a: Variable) -> Variable:
    """Paper's composition example, differentiable form."""
    a = _as_variable(a)
    ad = a.data
    out = ops.maximum(ad, ops.zeros_like(ad))

    def vjp(g):
        return (ops.mul(g, ops.astype(ops.gt(ad, ops.zeros_like(ad)),
                                      g.dtype)),)

    return record(out, (a,), vjp, "relu")


def matmul(a: Variable, b: Variable) -> Variable:
    """``a @ b`` with its VJP written out: ``g @ b^T`` and ``a^T @ g``,
    both through ``ops.matmul`` (the transposes are views, which the
    Hopper kernel reads through their strides).  For a 2-D ``b`` under a
    batched ``a`` (a Linear layer), the reference forms one ``a^T @ g``
    per leading index and sums them (``_unbroadcast``); here the leading
    dimensions fold into the contraction, the same sum as one product."""
    a, b = _as_variable(a), _as_variable(b)
    ad, bd = a.data, b.data
    out = ops.matmul(ad, bd)

    def _mT(x):
        perm = list(range(len(x.shape)))
        perm[-1], perm[-2] = perm[-2], perm[-1]
        return ops.transpose(x, tuple(perm))

    def vjp(g):
        ga = ops.matmul(g, _mT(bd))
        if len(bd.shape) == 2 and len(ad.shape) > 2:
            gb = ops.matmul(_mT(ops.reshape(ad, (-1, ad.shape[-1]))),
                            ops.reshape(g, (-1, g.shape[-1])))
        else:
            gb = ops.matmul(_mT(ad), g)
        return (_unbroadcast(ga, a.shape), _unbroadcast(gb, b.shape))

    return record(out, (a, b), vjp, "matmul")


# --------------------------------------------------------------------------
# reductions / shape
# --------------------------------------------------------------------------

def sum(a: Variable, axis=None, keepdims=False) -> Variable:  # noqa: A001
    a = _as_variable(a)
    out = ops.sum(a.data, axis=axis, keepdims=keepdims)
    in_shape = a.shape

    def vjp(g):
        if axis is None:
            return (ops.broadcast_to(ops.reshape(g, (1,) * len(in_shape)),
                                     in_shape),)
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(ax % len(in_shape) for ax in axes)
        if not keepdims:
            shape = list(in_shape)
            for ax in axes:
                shape[ax] = 1
            g = ops.reshape(g, tuple(shape))
        return (ops.broadcast_to(g, in_shape),)

    return record(out, (a,), vjp, "sum")


def mean(a: Variable, axis=None, keepdims=False) -> Variable:
    a = _as_variable(a)
    if axis is None:
        n = math.prod(a.shape) if a.shape else 1
    elif isinstance(axis, int):
        n = a.shape[axis]
    else:
        n = math.prod(a.shape[ax] for ax in axis)
    s = sum(a, axis=axis, keepdims=keepdims)
    return mul(s, Variable(ops.full_like(s.data, 1.0 / n)))


def max(a: Variable, axis=None, keepdims=False) -> Variable:  # noqa: A001
    a = _as_variable(a)
    ad = a.data
    out = ops.max(ad, axis=axis, keepdims=keepdims)

    def vjp(g):
        o = out
        if axis is not None and not keepdims:
            axes = (axis,) if isinstance(axis, int) else tuple(axis)
            shape = list(ad.shape)
            for ax in axes:
                shape[ax % len(shape)] = 1
            o = ops.reshape(out, tuple(shape))
            g = ops.reshape(g, tuple(shape))
        elif axis is None:
            o = ops.reshape(out, (1,) * len(ad.shape))
            g = ops.reshape(g, (1,) * len(ad.shape))
        mask = ops.astype(ops.eq(ad, o), g.dtype)
        denom = ops.sum(mask, axis=axis, keepdims=True)
        return (ops.div(ops.mul(mask, ops.broadcast_to(g, ad.shape)), denom),)

    return record(out, (a,), vjp, "max")


def reshape(a: Variable, shape) -> Variable:
    a = _as_variable(a)
    in_shape = a.shape
    out = ops.reshape(a.data, shape)
    return record(out, (a,), lambda g: (ops.reshape(g, in_shape),), "reshape")


def transpose(a: Variable, axes=None) -> Variable:
    a = _as_variable(a)
    out = ops.transpose(a.data, axes)
    if axes is None:
        inv = None
    else:
        inv = tuple(sorted(range(len(axes)), key=lambda i: axes[i]))
    return record(out, (a,), lambda g: (ops.transpose(g, inv),), "transpose")


def broadcast_to(a: Variable, shape) -> Variable:
    a = _as_variable(a)
    in_shape = a.shape
    out = ops.broadcast_to(a.data, shape)
    return record(out, (a,), lambda g: (_unbroadcast(g, in_shape),),
                  "broadcast_to")


def concatenate(vs, axis=0) -> Variable:
    vs = [_as_variable(v) for v in vs]
    out = ops.concatenate([v.data for v in vs], axis=axis)
    sizes = [v.shape[axis] for v in vs]

    def vjp(g):
        grads, start = [], 0
        for sz in sizes:
            starts = [0] * len(g.shape)
            limits = list(g.shape)
            starts[axis], limits[axis] = start, start + sz
            grads.append(ops.slice(g, starts, limits))
            start += sz
        return tuple(grads)

    return record(out, tuple(vs), vjp, "concatenate")


def getitem(a: Variable, idx) -> Variable:
    return lift(lambda x: x[idx], name="getitem")(a)


def take(a: Variable, indices, axis=0) -> Variable:
    """Embedding-style gather with scatter-add backward."""
    a = _as_variable(a)
    idx = indices.data if isinstance(indices, Variable) else indices
    out = ops.take(a.data, idx, axis=axis)
    in_shape = a.shape

    def vjp(g):
        zero = ops.zeros(in_shape, g.dtype, g.device)
        flat_idx = ops.reshape(idx, (-1,))
        lead = math.prod(g.shape[:len(idx.shape)]) if len(idx.shape) else 1
        g2 = ops.reshape(g, (lead,) + tuple(in_shape[axis + 1:])
                         if axis == 0 else g.shape)
        if axis != 0:
            raise NotImplementedError("take backward: axis != 0")
        return (ops.scatter_add(zero, flat_idx, g2, axis=0),)

    return record(out, (a,), vjp, "take")


def where(cond, a: Variable, b: Variable) -> Variable:
    a, b = _as_variable(a), _as_variable(b)
    c = cond.data if isinstance(cond, Variable) else cond
    out = ops.where(c, a.data, b.data)

    def vjp(g):
        z = ops.zeros_like(g)
        return (_unbroadcast(ops.where(c, g, z), a.shape),
                _unbroadcast(ops.where(c, z, g), b.shape))

    return record(out, (a, b), vjp, "where")


def astype(a: Variable, dtype) -> Variable:
    a = _as_variable(a)
    in_dtype = a.dtype
    out = ops.astype(a.data, dtype)
    return record(out, (a,), lambda g: (ops.astype(g, in_dtype),), "astype")


def stop_gradient(a: Variable) -> Variable:
    a = _as_variable(a)
    return Variable(ops.stop_gradient(a.data))


# --------------------------------------------------------------------------
# composite / NN ops (compositions stay differentiable automatically;
# heavy ones are lifted whole for single-node tapes)
# --------------------------------------------------------------------------

def sigmoid(a: Variable) -> Variable:
    a = _as_variable(a)
    out = ops.sigmoid(a.data)

    def vjp(g):
        return (ops.mul(g, ops.mul(out, ops.sub(ops.ones_like(out), out))),)

    return record(out, (a,), vjp, "sigmoid")


def gelu(a: Variable) -> Variable:
    return lift(ops.gelu, name="gelu")(a)


def silu(a: Variable) -> Variable:
    return lift(ops.silu, name="silu")(a)


def softmax(a: Variable, axis=-1) -> Variable:
    a = _as_variable(a)
    out = ops.softmax(a.data, axis=axis)

    def vjp(g):
        inner = ops.sum(ops.mul(g, out), axis=axis, keepdims=True)
        return (ops.mul(out, ops.sub(g, inner)),)

    return record(out, (a,), vjp, "softmax")


def log_softmax(a: Variable, axis=-1) -> Variable:
    a = _as_variable(a)
    out = ops.log_softmax(a.data, axis=axis)

    def vjp(g):
        sm = ops.exp(out)
        return (ops.sub(g, ops.mul(sm, ops.sum(g, axis=axis, keepdims=True))),)

    return record(out, (a,), vjp, "log_softmax")


def layer_norm(x: Variable, weight: Variable, bias: Variable,
               eps: float = 1e-5) -> Variable:
    return lift(lambda xx, w, b: ops.layer_norm(xx, w, b, eps),
                name="layer_norm")(x, weight, bias)


def rms_norm(x: Variable, weight: Variable, eps: float = 1e-6) -> Variable:
    return lift(lambda xx, w: ops.rms_norm(xx, w, eps), name="rms_norm")(x, weight)


def conv2d(x: Variable, w: Variable, stride=(1, 1), padding="SAME") -> Variable:
    return lift(lambda xx, ww: ops.conv2d(xx, ww, stride, padding),
                name="conv2d")(x, w)


def dot_general(a: Variable, b: Variable, dimension_numbers,
                preferred_element_type=None) -> Variable:
    return lift(lambda x, y: ops.dot_general(x, y, dimension_numbers,
                                             preferred_element_type),
                name="dot_general")(a, b)


def dropout(x: Variable, rate: float, key) -> Variable:
    if rate <= 0.0:
        return x
    x = _as_variable(x)
    mask = ops.dropout_mask(key, x.shape, rate, x.dtype, x.data.device)
    return mul(x, Variable(mask))


def embedding(table: Variable, token_ids) -> Variable:
    return take(table, _as_variable(token_ids), axis=0)


def cross_entropy(logits: Variable, labels, axis=-1) -> Variable:
    """Mean token cross-entropy; ``labels`` are integer ids."""
    lsm = log_softmax(logits, axis=axis)
    lab = labels.data if isinstance(labels, Variable) else labels
    nclass = logits.shape[-1]
    onehot = ops.one_hot(ops.reshape(lab, (-1,)), nclass, lsm.dtype)
    flat = reshape(lsm, (-1, nclass))
    nll = neg(sum(mul(flat, Variable(onehot))))
    n = math.prod(lab.shape) if hasattr(lab, "shape") else 1
    return mul(nll, Variable(ops.full_like(nll.data, 1.0 / float(n))))
