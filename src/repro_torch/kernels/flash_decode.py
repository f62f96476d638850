"""Paged flash-decode: the Hopper kernel (``csrc/flash_decode.cu``), its
plain PyTorch versions and its launch counter.

Replaces the Pallas ``flash_decode`` (``repro/kernels/flash_decode.py``)
on the decode path, where the reference runs the jnp
``plain_cache_attention`` over a fully gathered view.  The kernel reads
K/V through the block table in place and covers GQA and the tanh
softcap.  Call it through ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/flash_decode.cu"
REPLACES = "src/repro/kernels/flash_decode.py:134"

NEG_INF = -2.0 ** 30  # finite, as in the reference: masked rows stay NaN-free
HEAD_DIMS = (32, 64, 128, 256)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.SIGNATURES["flash_decode"] = {
    "repro_paged_decode": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _F, _F, _I, _P], ctypes.c_int),
}

launches = 0   # kernel launches since the last reset


def cache_attention_plain(q, k, v, valid, *, scale: float,
                          cap: float = 0.0) -> torch.Tensor:
    """``repro.models.attention.plain_cache_attention``: q ``[B, H, D]``
    against k, v ``[B, S, Kv, D]`` with validity ``[S]`` or ``[B, S]``;
    returns ``[B, H, D]`` in q's dtype."""
    b, h, dk = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, dk)
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    vmask = (valid if valid.ndim == 2 else valid[None])[:, None, None, :]
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if cap > 0:
        scores = torch.tanh(scores / cap) * cap
    scores = torch.where(vmask, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    e = torch.where(vmask, torch.exp(scores - m), 0.0)
    l = e.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", e.to(v.dtype), v).float()
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, kvh * g, -1).to(q.dtype)


def paged_read_index(table: torch.Tensor, block_size: int) -> torch.Tensor:
    """``[B, MB * block_size]`` pool rows of every slot's logical view
    (``repro.models.attention._paged_read_index``)."""
    mb = table.shape[1]
    pos = torch.arange(mb * block_size, device=table.device)
    return table[:, pos // block_size].long() * block_size \
        + (pos % block_size)[None, :]


def paged_plain(q, k_pool, v_pool, table, lengths, *, block_size: int,
                scale: float, cap: float = 0.0) -> torch.Tensor:
    """What the reference decode computes: gather each slot's logical
    view through the table, then ``plain_cache_attention`` with
    positions ``< lengths`` valid."""
    idx = paged_read_index(table, block_size)
    pos = torch.arange(idx.shape[1], device=q.device)
    valid = pos[None, :] < lengths[:, None]
    return cache_attention_plain(q, k_pool[idx], v_pool[idx], valid,
                                 scale=scale, cap=cap)


def contiguous_plain(q, k, v, valid, *, scale: float | None = None,
                     cap: float = 0.0) -> torch.Tensor:
    """``repro.kernels.ref.flash_decode``: q ``[N, D]``, k, v
    ``[N, S, D]``, valid ``[S]`` or ``[N, S]`` -> ``[N, D]``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / d ** 0.5
    return cache_attention_plain(q[:, None], k[:, :, None], v[:, :, None],
                                 valid, scale=scale, cap=cap)[:, 0]


def launch(q, k_pool, v_pool, table, lengths, mask, out, *,
           block_size: int, scale: float, cap: float) -> None:
    """Launch on PyTorch's current stream; the caller has checked every
    argument (``repro_torch.kernels.ops``).  ``mask`` is None or a
    contiguous bool ``[B, S]``."""
    global launches
    b, h, d = q.shape
    kvh = k_pool.shape[1]
    lib = build.library("flash_decode")
    status = lib.repro_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        lengths.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), b, h, kvh, d, table.shape[1], block_size,
        0 if mask is None else mask.shape[1], scale, cap,
        _DTYPE_CODE[q.dtype], build.stream_handle(q))
    build.check(status, "paged_decode")
    launches += 1
