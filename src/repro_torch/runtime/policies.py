"""Policies a :class:`~repro_torch.runtime.session.Session` carries,
copied from ``repro.runtime.policies`` so their checks read the same.

``KernelOverrides`` and ``PrecisionPolicy`` are the reference's, with
``resolve_dtype`` returning torch dtypes.  Serving: speculative decoding
is ported with the n-gram proposer (or one the caller passes);
``draft="model"`` is refused.  Prefix sharing is not ported yet: its
policy is kept (off by default) and the engine refuses it when enabled.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Any, Callable

import torch


def _callable_name(fn: Callable | None) -> str | None:
    if fn is None:
        return None
    name = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None)
    if name is None:
        name = type(fn).__name__
    mod = getattr(fn, "__module__", None)
    return f"{mod}.{name}" if mod else name


@dataclass(frozen=True)
class KernelOverrides:
    """Injectable kernels (``repro.runtime.policies.KernelOverrides``).

    attention:
        full-sequence attention, ``fn(q, k, v, *, positions, causal,
        window, prefix_len, scale, cap) -> [B, S, H, Dv]``; replaces the
        kernel in :func:`~repro_torch.models.attention.gqa_attention`.
    decode_attention:
        the reference's dense-cache decode attention ``fn(q, k, v, valid,
        *, scale, cap)``.  The port serves from the paged cache only, so
        ``ServeEngine`` refuses it until the dense cache is ported
        (ROADMAP queue 1 item 2).
    matmul:
        contraction ``fn(lhs, rhs)``; consulted by ``ops.matmul`` before
        backend dispatch.
    """

    attention: Callable | None = None
    decode_attention: Callable | None = None
    matmul: Callable | None = None

    def replace(self, **kw) -> "KernelOverrides":
        return dataclasses.replace(self, **kw)

    def describe(self) -> dict[str, str | None]:
        return {f.name: _callable_name(getattr(self, f.name))
                for f in fields(self)}


@dataclass(frozen=True)
class PrecisionPolicy:
    """Session-level dtype overrides applied when a model config is built
    (``repro_torch.configs.get_config``).

    ``None`` leaves the architecture config's own choice in place.
    Strings keep the policy serializable; ``resolve_dtype`` maps them to
    torch dtypes at the point of use.  ``cache_dtype`` follows the
    reference's convention, ``"compute"`` or ``"fp8"``; the port's caches
    hold the compute dtype, so ``"fp8"`` is refused by ``get_config``.
    """

    param_dtype: str | None = None
    compute_dtype: str | None = None
    cache_dtype: str | None = None

    def replace(self, **kw) -> "PrecisionPolicy":
        return dataclasses.replace(self, **kw)

    def describe(self) -> dict[str, str | None]:
        return {"param_dtype": self.param_dtype,
                "compute_dtype": self.compute_dtype,
                "cache_dtype": self.cache_dtype}


@dataclass(frozen=True)
class PrefixPolicy:
    """Prefix-sharing knobs (see ``repro.runtime.policies.PrefixPolicy``)."""

    enabled: bool = False
    retain: bool = True
    partial: bool = True

    def replace(self, **kw) -> "PrefixPolicy":
        return dataclasses.replace(self, **kw)

    def describe(self) -> dict:
        return {"enabled": self.enabled, "retain": self.retain,
                "partial": self.partial}


@dataclass(frozen=True)
class SpeculativePolicy:
    """Speculative-decoding knobs (see
    ``repro.runtime.policies.SpeculativePolicy``)."""

    enabled: bool = False
    k: int = 4
    draft: str = "ngram"
    ngram: int = 3

    def __post_init__(self) -> None:
        if self.draft not in ("ngram", "model"):
            raise ValueError(f"unknown draft kind {self.draft!r}; "
                             f"known: ('ngram', 'model')")
        if self.k < 1:
            raise ValueError("speculative k must be >= 1")

    def replace(self, **kw) -> "SpeculativePolicy":
        return dataclasses.replace(self, **kw)

    def describe(self) -> dict:
        return {"enabled": self.enabled, "k": self.k,
                "draft": self.draft, "ngram": self.ngram}


@dataclass(frozen=True)
class ServingPolicy:
    """Serving-scenario knobs.

    cache:
        KV-cache layout.  Only ``"paged"`` is ported (fixed-size blocks
        shared through a per-slot block table); ``"dense"`` is refused.
    block_size / num_blocks:
        positions per block, and total pool blocks (None derives a pool
        large enough that every slot can reach ``max_seq``; smaller
        pools exercise evict + requeue).
    scheduler:
        ``"fifo"``, ``"sjf"``, ``"priority"`` or a ``Scheduler`` instance.
    allocator:
        ``"caching"`` or ``"bump"`` (``core/memory/manager.py``).
    prefill_chunk:
        prompt tokens consumed per prefill call (must be > 0).
    prefix:
        kept for parity with the reference; must stay disabled.
    speculative:
        draft-propose / wide-verify / rollback rounds of up to ``k``
        proposals; ``draft="ngram"`` only.
    """

    cache: str = "paged"
    block_size: int = 16
    num_blocks: int | None = None
    scheduler: Any = "fifo"
    allocator: str = "caching"
    prefill_chunk: int = 16
    prefix: PrefixPolicy = PrefixPolicy()
    speculative: SpeculativePolicy = SpeculativePolicy()

    def __post_init__(self):
        pfx = self.prefix
        if isinstance(pfx, bool):
            pfx = PrefixPolicy(enabled=pfx)
        elif isinstance(pfx, dict):
            pfx = PrefixPolicy(**pfx)
        object.__setattr__(self, "prefix", pfx)
        spec = self.speculative
        if isinstance(spec, bool):
            spec = SpeculativePolicy(enabled=spec)
        elif isinstance(spec, dict):
            spec = SpeculativePolicy(**spec)
        object.__setattr__(self, "speculative", spec)

    def replace(self, **kw) -> "ServingPolicy":
        return dataclasses.replace(self, **kw)

    def describe(self) -> dict:
        sched = self.scheduler
        if not isinstance(sched, str):
            sched = getattr(sched, "name", None) or type(sched).__name__
        return {"cache": self.cache, "block_size": self.block_size,
                "num_blocks": self.num_blocks, "scheduler": sched,
                "allocator": self.allocator,
                "prefill_chunk": self.prefill_chunk,
                "prefix": self.prefix.describe(),
                "speculative": self.speculative.describe()}


_DTYPE_ALIASES = {
    "f32": "float32", "fp32": "float32", "float32": "float32",
    "f16": "float16", "fp16": "float16", "float16": "float16",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
}


def resolve_dtype(name: str) -> torch.dtype:
    """Map a policy dtype string to the torch dtype."""
    try:
        return getattr(torch, _DTYPE_ALIASES[name.lower()])
    except KeyError:
        raise ValueError(
            f"unknown precision dtype {name!r}; "
            f"known: {sorted(set(_DTYPE_ALIASES))}") from None
