"""Decoder-only LM facade (``repro.models.transformer.LM``), dense GQA.

The model lives on one device, the card unless the caller passes
``device="cpu"``.  Parameters are a nested dict in the reference's tree
layout (``embed``, ``final_norm``, ``lm_head``, ``stages[i]`` stacked on
a leading layer axis), so ``repro_torch.convert`` loads the reference's
weights leaf for leaf.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime.device import resolve_device

from .blocks import build_stages
from .layers import apply_norm, embed, embed_meta, norm_meta, unembed
from .meta import ParamMeta, tree_init


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE; logits fp32 [B,S,V], labels int [B,S]."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - gold).mean()
    if z_loss > 0:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss


class LM:
    def __init__(self, cfg, device: str | torch.device = "cuda"):
        if cfg.family != "dense" or cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: only dense GQA decoders are ported "
                f"(family={cfg.family!r}, attention={cfg.attention!r})")
        if cfg.norm != "rmsnorm":
            raise NotImplementedError(f"norm={cfg.norm!r} is not ported")
        if cfg.mtp_depth > 0:
            raise NotImplementedError("multi-token prediction (mtp_depth > 0) "
                                      "is not ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.stages = build_stages(cfg)

    # -- params -----------------------------------------------------------
    def abstract_params(self) -> dict:
        cfg = self.cfg
        out: dict[str, Any] = {
            "embed": embed_meta(cfg),
            "final_norm": norm_meta(cfg),
            "stages": [s.abstract() for s in self.stages],
        }
        if not cfg.tie_embeddings:
            out["lm_head"] = ParamMeta((cfg.vocab_size, cfg.d_model),
                                       cfg.param_dtype, "normal", 0.02)
        return out

    def init(self, seed: int) -> dict:
        """Random parameters from ``seed``, made on the model's device in
        ``param_dtype``."""
        return tree_init(self.abstract_params(), seed, self.device)

    def _head_table(self, p):
        return p["embed"] if self.cfg.tie_embeddings else p["lm_head"]

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- full sequence --------------------------------------------------------
    def _trunk(self, p, tokens):
        """Embed ``[B, S]`` tokens and run every stage at positions
        0..S-1; returns the last hidden states."""
        x = embed(p["embed"], self._tensor(tokens, torch.long), self.cfg)
        positions = torch.arange(x.shape[1], device=self.device)
        for stage, sp in zip(self.stages, p["stages"]):
            x = stage.apply(sp, x, positions=positions)
        return x

    def forward(self, p, tokens):
        """tokens ``[B, S]`` -> (logits ``[B, S, V]`` fp32, aux, hidden)."""
        x = self._trunk(p, tokens)
        h = apply_norm(p["final_norm"], x, self.cfg)
        logits = unembed(h, self._head_table(p), self.cfg)
        return logits, torch.zeros((), device=self.device), x

    # -- training loss --------------------------------------------------------
    def loss_fn(self, p, batch: dict):
        """(loss, {"ce", "moe_aux"}) for ``batch`` = {"tokens", "labels"}
        ``[B, S]``; differentiable in ``p``.  ``moe_aux`` is 0 for the
        dense decoders the port has."""
        cfg = self.cfg
        if batch.get("image_embeds") is not None:
            raise NotImplementedError("image embeddings (the VLM prefix) "
                                      "are not ported")
        labels = self._tensor(batch["labels"], torch.long)
        x = self._trunk(p, batch["tokens"])
        aux = torch.zeros((), device=self.device)
        h = apply_norm(p["final_norm"], x, cfg)
        table = self._head_table(p)
        if cfg.ce_impl == "chunked":
            loss = self._chunked_ce(h, table, labels)
        else:
            loss = cross_entropy_loss(unembed(h, table, cfg), labels)
        metrics = {"ce": loss, "moe_aux": aux}
        return loss + aux, metrics

    def _chunked_ce(self, h, table, labels, n_chunks: int = 16):
        """Never holds [B, S, V]: per-chunk unembed + CE over sequence
        chunks, each checkpointed so its logits are recomputed in the
        backward rather than kept.  The mean of the chunk means (chunks
        are equal in size)."""
        cfg = self.cfg
        s = h.shape[1]
        while s % n_chunks != 0:
            n_chunks //= 2
        c = s // n_chunks

        def chunk_loss(hc, lc):
            return cross_entropy_loss(unembed(hc, table, cfg), lc)

        losses = []
        for i in range(0, s, c):
            hc, lc = h[:, i:i + c], labels[:, i:i + c]
            losses.append(checkpoint(chunk_loss, hc, lc, use_reentrant=False)
                          if torch.is_grad_enabled() else chunk_loss(hc, lc))
        return torch.stack(losses).mean()

    # -- serving --------------------------------------------------------------
    def paged_cache_spec(self, batch: int, max_seq: int, *, num_blocks: int,
                         block_size: int):
        return [s.cache_spec(batch, max_seq, paged=(num_blocks, block_size))
                for s in self.stages]

    def init_paged_cache(self, batch: int, max_seq: int, *, num_blocks: int,
                         block_size: int):
        """Zeroed block pools, one ``{"k", "v"}`` per stage, each
        ``[layers, num_blocks * block_size, Kv, D]``."""
        return tree_init(self.paged_cache_spec(
            batch, max_seq, num_blocks=num_blocks, block_size=block_size),
            0, self.device)

    def has_recurrent_state(self) -> bool:
        return any(self.cfg.layer_kind(i) == "M"
                   for i in range(self.cfg.n_layers))

    def supports_paged_cache(self) -> bool:
        return not self.has_recurrent_state() and self.cfg.attention != "mla"

    def supports_chunked_prefill(self) -> bool:
        return self.supports_paged_cache()

    def _chunk(self, p, cache, tokens, start, count, block_table):
        """Run a ``[B, T]`` token span per slot through every layer,
        writing K/V at ``start[b] + t`` for the first ``count[b]`` tokens
        of each row; returns the last hidden states ``[B, T, D]``."""
        tokens = self._tensor(tokens, torch.long)
        x = embed(p["embed"], tokens, self.cfg)
        t = tokens.shape[1]
        positions = (self._tensor(start)[:, None]
                     + torch.arange(t, dtype=torch.int32,
                                    device=self.device)[None, :])
        count = self._tensor(count)
        for stage, sp, sc in zip(self.stages, p["stages"], cache):
            x, _ = stage.prefill_chunk(sp, sc, x, positions=positions,
                                       count=count, block_table=block_table)
        return x

    def prefill_step(self, p, cache, tokens, start, count, *, block_table):
        """Chunked batched prefill: a ``[B, T]`` chunk per slot, written
        into ``cache`` at positions ``start[b] + t`` for the first
        ``count[b]`` tokens of each row (count 0 = slot untouched).
        Updates the pools in place and returns them."""
        self._chunk(p, cache, tokens, start, count, block_table)
        return cache

    def supports_speculative(self) -> bool:
        """Speculative decoding rolls rejected positions back by
        truncating block tables, so every layer's cache must be
        position-addressed through the paged pool (the reference also
        excludes sliding-window layers, which the port does not have)."""
        return self.supports_paged_cache()

    def verify_step(self, p, cache, tokens, start, count, *, block_table):
        """Wide verify for speculative decoding: the span writes of
        ``prefill_step``, but returns (logits ``[B, T, V]`` fp32 for every
        position, cache) so one call scores all k + 1 proposals."""
        x = self._chunk(p, cache, tokens, start, count, block_table)
        h = apply_norm(p["final_norm"], x, self.cfg)
        return unembed(h, self._head_table(p), self.cfg), cache

    def decode_step(self, p, cache, token, pos, *, block_table):
        """token ``[B, 1]``; pos ``[B]`` per-slot positions.  Returns
        (logits ``[B, V]`` fp32, cache), the pools updated in place."""
        token = self._tensor(token, torch.long)
        pos = self._tensor(pos)
        x = embed(p["embed"], token, self.cfg)
        for stage, sp, sc in zip(self.stages, p["stages"], cache):
            x, _ = stage.decode(sp, sc, x, pos=pos, block_table=block_table)
        h = apply_norm(p["final_norm"], x, self.cfg)
        return unembed(h, self._head_table(p), self.cfg)[:, 0], cache
