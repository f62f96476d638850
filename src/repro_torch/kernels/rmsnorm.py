"""RMSNorm: the Hopper kernel (``csrc/rmsnorm.cu``), its plain PyTorch
version and its launch counter.

Replaces the Pallas ``rms_norm`` (``repro/kernels/rmsnorm.py``).  Bound
by memory: one read of x, one write of the output.  Call it through
``repro_torch.kernels.ops.rms_norm``, which checks its arguments and
takes the plain version for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:27"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.SIGNATURES["rmsnorm"] = {
    "repro_rmsnorm": ([_P, _P, _P, _I, _I, _F, _I, _I, _P], ctypes.c_int),
    "repro_rmsnorm_max_dim": ([_I], ctypes.c_int),
}

launches = 0   # kernel launches since the last reset


def plain(x: torch.Tensor, weight: torch.Tensor,
          eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` in fp32, cast back to x's
    dtype (``repro.kernels.ref.rms_norm``)."""
    x32 = x.float()
    ms = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


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
