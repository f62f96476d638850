"""PyTorch/CUDA port of ``repro`` (Flashlight in JAX) for NVIDIA Hopper.

A package of its own beside ``repro`` (the JAX reference): it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Module
paths mirror ``repro``'s, so ``repro_torch.models.attention`` is the
counterpart of ``repro.models.attention``.

Top-level API: the unified runtime Session, as in ``repro``::

    with repro_torch.session(backend="hopper") as s:
        ...       # every ops.matmul launches the hand-written Hopper GEMM

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on the CPU every kernel wrapper takes its plain PyTorch
version, which is what the parity tests hold against the JAX package.
"""

from repro_torch.runtime import (KernelOverrides, PrecisionPolicy,
                                 PrefixPolicy, ServingPolicy, Session,
                                 current_session, default_session, session)

__all__ = [
    "Session", "KernelOverrides", "PrecisionPolicy", "ServingPolicy",
    "PrefixPolicy", "session", "current_session", "default_session",
]
