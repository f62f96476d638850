"""Kernel-injected backend (``repro.core.tensor.pallas_backend``): the
hot primitives run hand-written Hopper kernels; everything else is the
eager PyTorch implementation it inherits.

The §5.2.4 demonstration on the card: subclass the default backend,
override ``matmul``, and every matmul of the core NN stack, forward and
tape backward, launches the hand-written GEMM (``csrc/matmul.cu``) with
no call-site changes.

The reference falls back to XLA on shapes that are not multiples of its
128-wide Mosaic tiles; the port's kernel masks its edges, so every
float32 or bfloat16 matmul takes it, of any shape and rank, transposed
or broadcast.  ``fallback_calls`` counts only what the kernel cannot take
(integer dtypes).  On CPU tensors every call takes the kernels' plain
versions, as the reference runs its kernels in interpret mode off a TPU.
``dot_general`` is not overridden, as ``PallasBackend`` does not, so the
model zoo's projections stay on cuBLAS.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

from .torch_backend import TorchBackend

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class HopperBackend(TorchBackend):
    name = "hopper"

    def __init__(self):
        self.kernel_calls = 0
        self.fallback_calls = 0

    def matmul(self, lhs, rhs):
        if lhs.dtype in _KERNEL_DTYPES and rhs.dtype in _KERNEL_DTYPES:
            self.kernel_calls += 1
            return kops.matmul(lhs, rhs)
        self.fallback_calls += 1
        return super().matmul(lhs, rhs)

    def rms_norm_fused(self, x, weight, eps: float = 1e-6):
        """Extended (non-primitive) hook: the RMSNorm kernel, which
        derived ops may probe the active backend for."""
        return kops.rms_norm(x, weight, eps=eps)
