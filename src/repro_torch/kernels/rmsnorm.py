"""RMSNorm: the Hopper kernels (``csrc/rmsnorm.cu``, forward and
backward), their plain PyTorch versions and their launch counters.

Replaces the Pallas ``rms_norm`` (``repro/kernels/rmsnorm.py``).  Bound
by memory: one read of x, one write of the output (the backward: x and
dy read once, dx written once, plus a small ``[blocks, D]`` fp32 scratch
for dw).  Call them through ``repro_torch.kernels.ops``, which checks the
arguments, takes the plain versions for tensors on the CPU and wraps both
in an autograd Function.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from . import build

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:27"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.SIGNATURES["rmsnorm"] = {
    "repro_rmsnorm": ([_P, _P, _P, _I, _I, _F, _I, _I, _P], ctypes.c_int),
    "repro_rmsnorm_max_dim": ([_I], ctypes.c_int),
    "repro_rmsnorm_bwd": ([_P] * 6 + [_I] * 3 + [_F, _I, _I, _P],
                          ctypes.c_int),
}

launches = 0   # forward kernel launches since the last reset
# the backward's two kernels (dx with dw partials, then dw) count as one
bwd = SimpleNamespace(SOURCE=SOURCE, REPLACES=REPLACES, launches=0)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """fp32, or float64 for float64 inputs (gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def plain(x: torch.Tensor, weight: torch.Tensor,
          eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` in fp32, cast back to x's
    dtype (``repro.kernels.ref.rms_norm``)."""
    x32 = _wide(x)
    ms = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * _wide(weight)).to(x.dtype)


def bwd_plain(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
              eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward from its formulas, fp32 inside: with inv =
    rsqrt(mean(x^2) + eps) and xhat = x * inv, dx = inv * (w * dy - xhat *
    mean(xhat * w * dy)) in x's dtype and dw = sum over rows of dy * xhat
    in w's dtype."""
    x32, dy32 = _wide(x), _wide(dy)
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    xhat = x32 * inv
    wdy = _wide(weight) * dy32
    dx = inv * (wdy - xhat * (xhat * wdy).mean(-1, keepdim=True))
    dw = (dy32 * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def max_dim(dtype: torch.dtype) -> int:
    return build.library("rmsnorm").repro_rmsnorm_max_dim(_DTYPE_CODE[dtype])


def launch(x2: torch.Tensor, weight: torch.Tensor, out: torch.Tensor,
           eps: float) -> None:
    """Launch on PyTorch's current stream.  ``x2``/``out`` are contiguous
    ``[N, D]`` on one CUDA device; the caller has checked everything."""
    global launches
    lib = build.library("rmsnorm")
    status = lib.repro_rmsnorm(
        x2.data_ptr(), weight.data_ptr(), out.data_ptr(), x2.shape[0],
        x2.shape[1], eps, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[weight.dtype],
        build.stream_handle(x2))
    build.check(status, "rms_norm")
    launches += 1


def launch_bwd(x2: torch.Tensor, weight: torch.Tensor, dy2: torch.Tensor,
               dx: torch.Tensor, dw: torch.Tensor, dw_part: torch.Tensor,
               eps: float) -> None:
    """Launch the backward on PyTorch's current stream.  ``x2``, ``dy2``,
    ``dx`` contiguous ``[N, D]``; ``dw`` ``[D]`` in weight's dtype;
    ``dw_part`` contiguous fp32 ``[blocks, D]`` scratch, blocks >= 1."""
    lib = build.library("rmsnorm")
    status = lib.repro_rmsnorm_bwd(
        x2.data_ptr(), weight.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), dw_part.data_ptr(), x2.shape[0], x2.shape[1],
        dw_part.shape[0], eps, _DTYPE_CODE[x2.dtype],
        _DTYPE_CODE[weight.dtype], build.stream_handle(x2))
    build.check(status, "rms_norm_bwd")
    bwd.launches += 1
