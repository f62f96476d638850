"""Eager PyTorch backend (``repro.core.tensor.jnp_backend.JnpBackend``):
every primitive a thin call into torch.

The default backend, as ``"jnp"`` is in the reference.  Its matmul and
dot_general go to ``torch.matmul`` / ``torch.tensordot`` (cuBLAS on the
card), as the reference's go to XLA.  Results follow the reference's
dtypes where PyTorch would widen: integer sums, products and cumulative
sums keep the input's integer dtype, a boolean sum is int32.  Index
results (``argmax``, ``top_k``) are int64, PyTorch's index dtype.
``conv2d`` keeps the reference's NHWC activations and HWIO weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .backend import TensorBackend


def _dims(x: torch.Tensor, axis) -> tuple[int, ...]:
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        return (axis % max(x.ndim, 1),)
    return tuple(a % x.ndim for a in axis)


def _int_dtype(x: torch.Tensor) -> torch.dtype | None:
    """The reference's result dtype for an integer reduction of ``x``
    (None for floating inputs)."""
    if x.dtype == torch.bool:
        return torch.int32
    if not x.dtype.is_floating_point and not x.dtype.is_complex:
        return x.dtype
    return None


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dimension."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class TorchBackend(TensorBackend):
    name = "torch"

    # creation
    def full(self, shape, fill_value, dtype, device):
        return torch.full(tuple(shape), fill_value, dtype=dtype,
                          device=device)

    def arange(self, start, stop, step, dtype, device):
        return torch.arange(start, stop, step, dtype=dtype, device=device)

    def iota(self, dtype, shape, dimension, device):
        shape = tuple(shape)
        view = [1] * len(shape)
        view[dimension] = shape[dimension]
        return torch.arange(shape[dimension], dtype=dtype,
                            device=device).reshape(view).expand(shape)

    def random_uniform(self, key, shape, dtype, minval, maxval, device):
        u = torch.rand(tuple(shape), generator=key, device=key.device,
                       dtype=torch.float32)
        return (u * (maxval - minval) + minval).to(device=device,
                                                   dtype=dtype)

    def random_normal(self, key, shape, dtype, device):
        return torch.randn(tuple(shape), generator=key, device=key.device,
                           dtype=torch.float32).to(device=device,
                                                   dtype=dtype)

    # unary
    def neg(self, x):
        return torch.neg(x)

    def exp(self, x):
        return torch.exp(x)

    def log(self, x):
        return torch.log(x)

    def sin(self, x):
        return torch.sin(x)

    def cos(self, x):
        return torch.cos(x)

    def tanh(self, x):
        return torch.tanh(x)

    def sqrt(self, x):
        return torch.sqrt(x)

    def rsqrt(self, x):
        return torch.rsqrt(x)

    def abs(self, x):
        return torch.abs(x)

    def sign(self, x):
        return torch.sign(x)

    def floor(self, x):
        return torch.floor(x)

    def erf(self, x):
        return torch.erf(x)

    def logical_not(self, x):
        return torch.logical_not(x)

    def isnan(self, x):
        return torch.isnan(x)

    # binary
    def add(self, lhs, rhs):
        return torch.add(lhs, rhs)

    def sub(self, lhs, rhs):
        return torch.sub(lhs, rhs)

    def mul(self, lhs, rhs):
        return torch.mul(lhs, rhs)

    def div(self, lhs, rhs):
        return torch.div(lhs, rhs)

    def pow(self, lhs, rhs):
        return torch.pow(lhs, rhs)

    def maximum(self, lhs, rhs):
        return torch.maximum(lhs, rhs)

    def minimum(self, lhs, rhs):
        return torch.minimum(lhs, rhs)

    def mod(self, lhs, rhs):
        return torch.remainder(lhs, rhs)      # sign of the divisor, as jnp

    def eq(self, lhs, rhs):
        return torch.eq(lhs, rhs)

    def ne(self, lhs, rhs):
        return torch.ne(lhs, rhs)

    def lt(self, lhs, rhs):
        return torch.lt(lhs, rhs)

    def le(self, lhs, rhs):
        return torch.le(lhs, rhs)

    def gt(self, lhs, rhs):
        return torch.gt(lhs, rhs)

    def ge(self, lhs, rhs):
        return torch.ge(lhs, rhs)

    def logical_and(self, lhs, rhs):
        return torch.logical_and(lhs, rhs)

    def logical_or(self, lhs, rhs):
        return torch.logical_or(lhs, rhs)

    # reductions
    def sum(self, x, axis, keepdims):
        if x.ndim == 0:
            return x.to(_int_dtype(x) or x.dtype)
        return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims,
                         dtype=_int_dtype(x))

    def max(self, x, axis, keepdims):
        if x.ndim == 0:
            return x
        return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims)

    def min(self, x, axis, keepdims):
        if x.ndim == 0:
            return x
        return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims)

    def prod(self, x, axis, keepdims):
        out = x.to(_int_dtype(x) or x.dtype)
        for d in sorted(_dims(x, axis), reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims,
                             dtype=_int_dtype(x))
        return out

    def argmax(self, x, axis):
        return torch.argmax(x, dim=axis)

    def cumsum(self, x, axis):
        return torch.cumsum(x, dim=axis, dtype=_int_dtype(x))

    # shape / data movement
    def reshape(self, x, shape):
        return torch.reshape(x, tuple(shape))

    def transpose(self, x, axes):
        if axes is None:
            axes = tuple(reversed(range(x.ndim)))
        return torch.permute(x, tuple(axes))

    def broadcast_to(self, x, shape):
        return torch.broadcast_to(x, tuple(shape))

    def concatenate(self, xs, axis):
        return torch.cat(list(xs), dim=axis)

    def slice(self, x, start, limit):
        return x[tuple(slice(int(s), int(l)) for s, l in zip(start, limit))]

    def dynamic_slice(self, x, start_indices, slice_sizes):
        # lax clamps each start so that the slice stays inside x
        idx = tuple(slice(st, st + sz) for st, sz in (
            (min(max(int(s), 0), d - z), z)
            for s, z, d in zip(start_indices, slice_sizes, x.shape)))
        return x[idx]

    def dynamic_update_slice(self, x, update, start_indices):
        idx = tuple(slice(st, st + z) for st, z in (
            (min(max(int(s), 0), d - z), z)
            for s, z, d in zip(start_indices, update.shape, x.shape)))
        out = x.clone()
        out[idx] = update
        return out

    def pad(self, x, pad_width, value):
        flat = []
        for lo, hi in reversed(list(pad_width)):
            flat += [int(lo), int(hi)]
        return F.pad(x, flat, mode="constant", value=value)

    def where(self, cond, x, y):
        return torch.where(cond, x, y)

    def take(self, x, indices, axis):
        axis = axis % x.ndim
        out = torch.index_select(x, axis, indices.reshape(-1))
        return out.reshape(x.shape[:axis] + tuple(indices.shape)
                           + x.shape[axis + 1:])

    def take_along_axis(self, x, indices, axis):
        return torch.take_along_dim(x, indices.long(), dim=axis)

    def scatter_add(self, x, indices, updates, axis):
        axis = axis % x.ndim
        idx = indices.reshape(-1)
        upd = updates.reshape(x.shape[:axis] + (idx.shape[0],)
                              + x.shape[axis + 1:])
        return torch.index_add(x, axis, idx, upd.to(x.dtype))

    def flip(self, x, axis):
        return torch.flip(x, _dims(x, axis))

    def sort(self, x, axis):
        return torch.sort(x, dim=axis).values

    def top_k(self, x, k):
        out = torch.topk(x, k, dim=-1)
        return out.values, out.indices

    def astype(self, x, dtype):
        return x.to(dtype)

    def stop_gradient(self, x):
        return x.detach()

    # linear algebra
    def matmul(self, lhs, rhs):
        return torch.matmul(lhs, rhs)

    def dot_general(self, lhs, rhs, dimension_numbers, preferred_element_type):
        """``lax.dot_general``: output dims are the batch dims, then the
        free dims of lhs, then those of rhs.  ``preferred_element_type``
        casts both operands first, so products are formed and summed in
        that type."""
        (lc, rc), (lb, rb) = dimension_numbers
        if preferred_element_type is not None:
            lhs = lhs.to(preferred_element_type)
            rhs = rhs.to(preferred_element_type)
        if (not lb and rhs.ndim == 2 and tuple(rc) == (0,)
                and tuple(lc) == (lhs.ndim - 1,)):
            # [..., K] @ [K, N], every projection of the model zoo: the
            # same product as tensordot's, with less host work per call
            return torch.matmul(lhs, rhs)
        if not lb:
            return torch.tensordot(lhs, rhs, dims=(list(lc), list(rc)))
        letters = iter("abcdefghijklmnopqrstuvwxyz")
        ls = [next(letters) for _ in range(lhs.ndim)]
        rs = [next(letters) for _ in range(rhs.ndim)]
        for i, j in zip(lc, rc):
            rs[j] = ls[i]
        for i, j in zip(lb, rb):
            rs[j] = ls[i]
        out = ([ls[i] for i in lb]
               + [ls[i] for i in range(lhs.ndim) if i not in lc + lb]
               + [rs[j] for j in range(rhs.ndim) if j not in rc + rb])
        return torch.einsum(f"{''.join(ls)},{''.join(rs)}->{''.join(out)}",
                            lhs, rhs)

    def conv2d(self, x, w, stride, padding):
        """NHWC activations, HWIO weights, "SAME" / "VALID" / explicit
        ``[(lo, hi), (lo, hi)]`` padding as ``lax.conv_general_dilated``;
        the output is a contiguous NHWC tensor."""
        kh, kw = w.shape[0], w.shape[1]
        xc = x.permute(0, 3, 1, 2)
        if padding == "VALID":
            pads = ((0, 0), (0, 0))
        elif padding == "SAME":
            pads = (_same_pads(xc.shape[2], kh, stride[0]),
                    _same_pads(xc.shape[3], kw, stride[1]))
        else:
            pads = tuple(tuple(p) for p in padding)
        (t, b), (l, r) = pads
        if t or b or l or r:
            xc = F.pad(xc, [l, r, t, b])
        out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride))
        return out.permute(0, 2, 3, 1).contiguous()
