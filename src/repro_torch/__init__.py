"""PyTorch/CUDA port of the ``repro`` serving path for NVIDIA Hopper.

A package of its own beside ``repro`` (the JAX reference): it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Module
paths mirror ``repro``'s, so ``repro_torch.models.attention`` is the
counterpart of ``repro.models.attention``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on the CPU every kernel wrapper takes its plain PyTorch
version, which is what the parity tests hold against the JAX package.
"""
