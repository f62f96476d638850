"""Serving policies, copied from ``repro.runtime.policies`` so the
engine's checks read the same.

The port has no Session: a ``ServingPolicy`` is passed to the engine
directly.  Speculative decoding is ported with the n-gram proposer (or
one the caller passes); ``draft="model"`` is refused.  Prefix sharing
is not ported yet: its policy is kept (off by default) and the engine
refuses it when enabled.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


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
