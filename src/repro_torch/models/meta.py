"""Parameter metas: shape, dtype and initializer of every leaf.

``tree_init`` instantiates a tree of metas directly on the target device
in the meta's dtype, drawing from one explicit ``torch.Generator``.
Random draws differ from ``jax.random`` for the same seed; parity tests
convert the reference's weights instead (``repro_torch.convert``).

``fan_in`` init uses the input width of the (per-layer) matrix,
``shape[-2]``, also for stacked leaves.  The reference reads ``shape[0]``
of the stacked leaf, which is the layer count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"               # normal | zeros | ones | fan_in
    scale: float = 0.02

    def instantiate(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "fan_in":
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[0]
            std = 1.0 / math.sqrt(max(1, fan_in))
        else:
            std = self.scale
        out = torch.randn(self.shape, generator=generator, device=device,
                          dtype=torch.float32)
        return out.mul_(std).to(self.dtype)


def stacked(meta: ParamMeta, n: int) -> ParamMeta:
    """Add a leading layer axis (the reference's scan-stacked layout)."""
    return ParamMeta((n,) + meta.shape, meta.dtype, meta.init, meta.scale)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (anything that is not a dict,
    list or tuple); each of ``rest`` is walked in step and hands ``fn``
    its subtree at the leaf's place, so it may be deeper (an optimizer
    state of ``{"m", "v"}`` per parameter)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in its order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def stack_tree(metas: Any, n: int) -> Any:
    return tree_map(lambda m: stacked(m, n), metas)


def tree_init(metas: Any, seed: int, device: torch.device) -> Any:
    """Instantiate every meta, in tree order, from one seeded generator
    on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(lambda m: m.instantiate(gen, device), metas)
