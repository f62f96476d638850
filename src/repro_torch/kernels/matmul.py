"""Matmul: the Hopper kernel (``csrc/matmul.cu``), its plain PyTorch
version and its launch counter.

Replaces the Pallas ``matmul`` (``repro/kernels/matmul.py``): C = A @ B
with fp32 accumulation across K, rounded once to ``promote_types(A, B)``.
Bound by arithmetic at the core stack's shapes: fp32 runs on the CUDA
cores (no TF32), bf16 on the tensor cores.  Call it through
``repro_torch.kernels.ops.matmul``, which takes the plain version for
tensors on the CPU, folds and broadcasts the leading dimensions and
checks the arguments.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/matmul.cu"
REPLACES = "src/repro/kernels/matmul.py:47"

DTYPES = (torch.float32, torch.bfloat16)
MAX_BATCH_DIMS = 3          # batch dimensions the kernel walks (grid z)
MAX_GRID_YZ = 65535         # CUDA's limit on grid.y and grid.z
TILE_M = 128                # rows of C per block (both kernels)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_LL5 = ctypes.c_longlong * 5
_I3 = ctypes.c_int * 3
build.SIGNATURES["matmul"] = {
    "repro_matmul": ([_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P, _P],
                     ctypes.c_int),
}

launches = 0   # kernel launches since the last reset


def plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` semantics (broadcast batch dimensions, 1-D
    operands) computed in fp32 (float64 stays float64) and cast once to
    ``promote_types(a, b)``: the reference's ``_matmul_kernel``, which
    accumulates ``jnp.dot(..., preferred_element_type=float32)`` and
    casts on the last K step.  On a card, call it with
    ``torch.backends.cuda.matmul.allow_tf32`` off to get fp32 products."""
    out = torch.promote_types(a.dtype, b.dtype)
    wide = torch.promote_types(out, torch.float32)
    return torch.matmul(a.to(wide), b.to(wide)).to(out)


def launch(a: torch.Tensor, a_strides: tuple[int, ...], b: torch.Tensor,
           b_strides: tuple[int, ...], c: torch.Tensor, m: int, n: int,
           k: int, batch: tuple[int, int, int]) -> None:
    """Launch on PyTorch's current stream.  ``a_strides`` / ``b_strides``
    are (row, col, batch0, batch1, batch2) element strides of A [.., M, K]
    and B [.., K, N] (0 broadcasts a batch dimension); ``c`` is a
    contiguous [batch0 * batch1 * batch2, M, N] of the promoted dtype.
    The caller has checked everything."""
    global launches
    lib = build.library("matmul")
    status = lib.repro_matmul(
        a.data_ptr(), _LL5(*a_strides), _DTYPE_CODE[a.dtype],
        b.data_ptr(), _LL5(*b_strides), _DTYPE_CODE[b.dtype],
        c.data_ptr(), m, n, k, _I3(*batch), build.stream_handle(c))
    build.check(status, "matmul")
    launches += 1
