"""GQA attention (``repro.models.attention``): full-sequence attention
for training and ``forward``, and the serving path.

Full-sequence attention on the card runs the flash-attention kernels
(forward and backward, through their autograd Function) for every
``attention_impl``, unless the session injects its own
(``session(kernels={"attention": fn})``, as in the reference); on the CPU ``ref`` and ``blockwise`` run the
reference's masked grouped softmax and ``pallas`` runs the kernel's plain
version.  Decode writes the new K/V into the paged pool in place and runs the
paged flash-decode kernel; chunked prefill (and the speculative wide
verify, which goes through it) writes the chunk into the pool and runs
the paged flash-verify kernel.  Both kernels read K/V through the block
table, so no gathered view is built.  Caches hold the compute dtype (fp8
storage and sliding-window ring buffers are not ported).

The cache tensors are updated in place (the reference returns new
immutable arrays); the functions still return the cache so their
signatures read the same.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_verify import grouped_attention_plain
from repro_torch.runtime.stack import current_session

from .layers import apply_rope, linear
from .meta import ParamMeta

# -- masks --------------------------------------------------------------------

def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              prefix_len: int = 0) -> torch.Tensor:
    """[Sq, Sk] boolean mask. window>0 = sliding window; prefix positions
    (< prefix_len) are bidirectionally visible (PaLI-style prefix-LM)."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    m = (q >= k) if causal else torch.ones(
        q_pos.shape[0], kv_pos.shape[0], dtype=torch.bool, device=q.device)
    if window > 0:
        m = m & (q - k < window)
    if prefix_len > 0:
        m = m | (k < prefix_len)
    return m


# -- GQA ----------------------------------------------------------------------

def gqa_meta(cfg) -> dict[str, ParamMeta]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.param_dtype
    return {
        "wq": ParamMeta((d, h * hd), dt, "fan_in"),
        "wk": ParamMeta((d, kv * hd), dt, "fan_in"),
        "wv": ParamMeta((d, kv * hd), dt, "fan_in"),
        "wo": ParamMeta((h * hd, d), dt, "fan_in"),
    }


def _qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"]).reshape(b, s, h, hd)
    k = linear(x, p["wk"]).reshape(b, s, kv, hd)
    v = linear(x, p["wv"]).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_ref(q, k, v, mask, scale, cap: float = 0.0):
    """The reference's grouped attention: q ``[B, S, H, D]``, k/v
    ``[B, S, Kv, D]``, mask ``[Sq, Sk]`` shared by the batch."""
    b, sq = q.shape[:2]
    return grouped_attention_plain(q, k, v, mask.expand(b, sq, -1),
                                   scale=scale, cap=cap)


def _sdpa_blockwise(q, k, v, positions, *, causal, window, prefix_len,
                    scale, cap: float = 0.0, q_chunk: int = 1024):
    """Query-chunked attention: the score buffer is ``[B, Kv, G,
    q_chunk, S]`` instead of O(S^2); exact (full softmax row per chunk)."""
    s = q.shape[1]
    while s % q_chunk != 0:
        q_chunk //= 2
    out = []
    for i in range(0, s, q_chunk):
        mask = make_mask(positions[i:i + q_chunk], positions, causal=causal,
                         window=window, prefix_len=prefix_len)
        out.append(_sdpa_ref(q[:, i:i + q_chunk], k, v, mask, scale, cap))
    return torch.cat(out, 1)


def gqa_attention(p, x, cfg, *, positions, window: int = 0,
                  prefix_len: int = 0, causal: bool = True):
    """Full-sequence attention (train / ``forward``) at ``positions`` =
    0..S-1.  On the card every ``attention_impl`` runs the flash-attention
    kernels (a prefix-LM mask is not one of the kernel's masks and
    raises); on the CPU ``pallas`` runs their plain versions through the
    same autograd Function, ``blockwise`` the query-chunked reference and
    ``ref`` the reference's masked grouped softmax."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    override = current_session().kernels.attention
    if override is not None:
        out = override(q, k, v, positions=positions, causal=causal,
                       window=window, prefix_len=prefix_len, scale=scale,
                       cap=cfg.logit_softcap)
    elif x.is_cuda or (cfg.attention_impl == "pallas" and prefix_len == 0):
        if prefix_len > 0:
            raise NotImplementedError(
                "gqa_attention: the flash-attention kernel takes causal and "
                "window masks, not a prefix-LM prefix")
        out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, softcap=cfg.logit_softcap)
    elif cfg.attention_impl == "blockwise":
        out = _sdpa_blockwise(q, k, v, positions, causal=causal,
                              window=window, prefix_len=prefix_len,
                              scale=scale, cap=cfg.logit_softcap)
    else:
        mask = make_mask(positions, positions, causal=causal, window=window,
                         prefix_len=prefix_len)
        out = _sdpa_ref(q, k, v, mask, scale, cfg.logit_softcap)
    return linear(out.reshape(b, s, -1), p["wo"])


def gqa_cache_spec(cfg, batch: int, max_seq: int, paged=None):
    """Cache metas for one layer: ``paged=(num_blocks, block_size)`` lays
    the cache out as a block pool shared by all slots."""
    if paged is None:
        raise NotImplementedError("the dense KV cache is not ported; "
                                  "use the paged layout")
    num_blocks, block_size = paged
    p = num_blocks * block_size
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.resolved_cache_dtype
    return {"k": ParamMeta((p, kv, hd), dt, "zeros"),
            "v": ParamMeta((p, kv, hd), dt, "zeros")}


# -- paged (block-table) addressing -------------------------------------------
# ``block_table`` is anything with ``.table`` ([B, MB] int32 physical block
# ids on the model's device) and ``.block_size`` (int); the class lives in
# repro_torch/serving/kv_cache.py.

def _paged_write_index(block_table, pos):
    """Physical pool row for writing position ``pos`` ([B] or [B, T]).
    Block indices past the table clamp to its last column, as the
    reference's gather does; such writes must be dropped by the caller."""
    bs = block_table.block_size
    table = block_table.table
    col = (pos // bs).reshape(pos.shape[0], -1).clamp(max=table.shape[1] - 1)
    blk = torch.gather(table, 1, col.long()).reshape(pos.shape)
    return blk.long() * bs + pos % bs


def gqa_decode(p, cache, x, cfg, *, pos, block_table):
    """One decode step over the paged pool.  x ``[B, 1, D]``; pos ``[B]``
    int per-slot positions.  Writes the new K/V at ``pos`` through the
    table, then attends positions ``0..pos`` with the paged kernel."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"]).reshape(b, 1, h, hd)
    k = linear(x, p["wk"]).reshape(b, 1, kv, hd)
    v = linear(x, p["wv"]).reshape(b, 1, kv, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0]     # [B, H, D]
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    phys = _paged_write_index(block_table, pos)               # [B]
    cache["k"][phys] = k[:, 0].to(cache["k"].dtype)
    cache["v"][phys] = v[:, 0].to(cache["v"].dtype)
    lengths = (pos + 1).to(torch.int32)
    out = kops.paged_decode(q.contiguous(), cache["k"], cache["v"],
                            block_table.table, lengths,
                            block_size=block_table.block_size,
                            scale=1.0 / math.sqrt(hd), cap=cfg.logit_softcap)
    return linear(out.reshape(b, 1, -1), p["wo"]), cache


def gqa_prefill_chunk(p, cache, x, cfg, *, positions, count, block_table):
    """Chunked batched prefill, and the speculative wide verify: x
    ``[B, T, D]`` at per-token positions ``[B, T]`` (``start[b] + t``);
    the first ``count[b]`` tokens of each row are real (0 = slot not
    prefilling: its writes are dropped and its outputs, zeros here, are
    garbage the caller discards).  The chunk's K/V go into the pool
    first, so its queries read back cache-dtype values as the reference's
    do; then the paged flash-verify kernel attends each token to
    positions ``0..start[b] + t`` through the table."""
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    tok_valid = (torch.arange(t, device=x.device)[None, :]
                 < count[:, None])
    # padding tokens write into the trash block 0 instead of being
    # dropped: nothing reads it as valid, and no host sync is needed
    bs = block_table.block_size
    phys = _paged_write_index(block_table, positions)         # [B, T]
    phys = torch.where(tok_valid, phys, positions % bs)
    cache["k"][phys] = k.to(cache["k"].dtype)
    cache["v"][phys] = v.to(cache["v"].dtype)
    out = kops.paged_verify(
        q.contiguous(), cache["k"], cache["v"], block_table.table,
        positions[:, 0].to(torch.int32).contiguous(),
        count.to(torch.int32), block_size=bs,
        scale=1.0 / math.sqrt(cfg.resolved_head_dim), cap=cfg.logit_softcap)
    return linear(out.reshape(b, t, -1), p["wo"]), cache
