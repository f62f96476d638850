"""Decoder blocks and stages (``repro.models.blocks``), dense GQA only.

Each stage keeps its parameters and caches stacked on a leading layer
axis, the layout of the reference's ``lax.scan`` stages, and a Python
loop over the layers replaces the scan.  Under autograd a scanned stage
checkpoints each layer as the reference's ``_remat`` does: ``remat="full"``
saves only each layer's input and recomputes the layer in the backward.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import apply_mlp, apply_norm, mlp_meta, norm_meta
from .meta import stack_tree


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i``'s view of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


class DecoderLayer:
    """One pre-norm attention + gated-MLP layer (kind ``"A"``)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def abstract(self) -> dict:
        cfg = self.cfg
        return {"norm1": norm_meta(cfg), "attn": attn.gqa_meta(cfg),
                "norm2": norm_meta(cfg), "mlp": mlp_meta(cfg)}

    def cache_spec(self, batch: int, max_seq: int, paged=None) -> dict:
        return attn.gqa_cache_spec(self.cfg, batch, max_seq, paged=paged)

    def _mlp(self, p, x):
        return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, self.cfg),
                             self.cfg)

    def apply(self, p, x, *, positions):
        h = apply_norm(p["norm1"], x, self.cfg)
        x = x + attn.gqa_attention(p["attn"], h, self.cfg,
                                   positions=positions)
        return self._mlp(p, x)

    def decode(self, p, cache, x, *, pos, block_table):
        h = apply_norm(p["norm1"], x, self.cfg)
        h, cache = attn.gqa_decode(p["attn"], cache, h, self.cfg, pos=pos,
                                   block_table=block_table)
        return self._mlp(p, x + h), cache

    def prefill_chunk(self, p, cache, x, *, positions, count, block_table):
        h = apply_norm(p["norm1"], x, self.cfg)
        h, cache = attn.gqa_prefill_chunk(p["attn"], cache, h, self.cfg,
                                          positions=positions, count=count,
                                          block_table=block_table)
        return self._mlp(p, x + h), cache


class Stage:
    """``repeats`` copies of one layer with stacked params and caches."""

    def __init__(self, cfg, block: DecoderLayer, repeats: int):
        self.cfg = cfg
        self.block = block
        self.repeats = repeats

    def abstract(self):
        return stack_tree(self.block.abstract(), self.repeats)

    def cache_spec(self, batch, max_seq, paged=None):
        return stack_tree(self.block.cache_spec(batch, max_seq, paged=paged),
                          self.repeats)

    def apply(self, p, x, **kw):
        """The stage's layers in order.  ``remat`` follows the
        reference's ``_remat``, which wraps the scan body: ``"none"`` keeps
        every activation, ``"full"`` checkpoints each layer (non-reentrant:
        the backward recomputes it from its saved input), ``"dots"`` (save
        the matmul outputs) is not ported.  Like the reference, a stage
        that is not scanned (``scan_layers=False`` or one layer) is not
        rematerialised."""
        remat = self.cfg.remat
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat policy {remat!r}")
        if remat == "dots":
            raise NotImplementedError(
                "remat='dots' (save matmul outputs) is not ported")
        scan = self.cfg.scan_layers and self.repeats > 1
        recompute = (scan and remat == "full" and torch.is_grad_enabled())
        for i in range(self.repeats):
            lp = layer_slice(p, i)
            if recompute:
                x = checkpoint(self.block.apply, lp, x, use_reentrant=False,
                               **kw)
            else:
                x = self.block.apply(lp, x, **kw)
        return x

    def decode(self, p, cache, x, **kw):
        for i in range(self.repeats):
            x, _ = self.block.decode(layer_slice(p, i),
                                     layer_slice(cache, i), x, **kw)
        return x, cache

    def prefill_chunk(self, p, cache, x, **kw):
        for i in range(self.repeats):
            x, _ = self.block.prefill_chunk(layer_slice(p, i),
                                            layer_slice(cache, i), x, **kw)
        return x, cache


def build_stages(cfg) -> list[Stage]:
    """A dense config is one stage of ``n_layers`` identical layers."""
    return [Stage(cfg, DecoderLayer(cfg), cfg.n_layers)]
