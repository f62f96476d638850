"""Paged flash-verify: the Hopper kernel (``csrc/flash_verify.cu``), its
plain PyTorch versions and its launch counter.

Replaces the Pallas ``flash_verify`` (``repro/kernels/flash_decode.py``)
on the chunked-prefill and speculative-verify paths, where the
reference runs ``_sdpa_ref`` over a fully gathered view: T query rows
per slot, row ``t < count`` at position ``start + t`` attending
positions ``0..start + t``, K/V read in place through the block table.
Call it through ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_decode import NEG_INF, paged_read_index

SOURCE = "src/repro_torch/csrc/flash_verify.cu"
REPLACES = "src/repro/kernels/flash_decode.py:92"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.SIGNATURES["flash_verify"] = {
    "repro_paged_verify": ([_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
                           ctypes.c_int),
}

launches = 0   # kernel launches since the last reset


def grouped_attention_plain(q, k, v, valid, *, scale: float,
                            cap: float = 0.0) -> torch.Tensor:
    """q ``[B, T, H, D]`` against k, v ``[B, S, Kv, D]`` with validity
    ``[B, T, S]``; returns ``[B, T, H, D]`` in q's dtype.

    The reference's ``_sdpa_ref`` order of rounding (fp32 scores and
    softmax, weights rounded to v's dtype before the PV product), except
    that a row with no valid key gives 0, as ``ref.flash_verify`` and
    the kernel do, where ``_sdpa_ref`` would average every position."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    qg = q.reshape(b, t, kvh, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if cap > 0:
        scores = torch.tanh(scores / cap) * cap
    vmask = valid[:, None, None]                           # [B, 1, 1, T, S]
    scores = torch.where(vmask, scores, NEG_INF)
    e = torch.where(vmask, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    0.0)
    w = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", w.to(v.dtype), v)
    return out.reshape(b, t, h, d).to(q.dtype)


def verify_valid(start, count, t: int, length: int) -> torch.Tensor:
    """``[B, T, length]``: row ``t < count[b]`` sees positions
    ``<= start[b] + t``; rows past ``count`` see nothing."""
    rows = torch.arange(t, device=start.device)
    pos = start.long()[:, None] + rows[None, :]               # [B, T]
    keys = torch.arange(length, device=start.device)
    row_ok = rows[None, :] < count.long()[:, None]
    return (keys[None, None, :] <= pos[..., None]) & row_ok[..., None]


def paged_plain(q, k_pool, v_pool, table, start, count, *, block_size: int,
                scale: float, cap: float = 0.0) -> torch.Tensor:
    """Gather each slot's logical view through the table, then grouped
    attention with the staircase validity of ``verify_valid``."""
    idx = paged_read_index(table, block_size)
    valid = verify_valid(start, count, q.shape[1], idx.shape[1])
    return grouped_attention_plain(q, k_pool[idx], v_pool[idx], valid,
                                   scale=scale, cap=cap)


def contiguous_plain(q, k, v, valid, *, scale: float | None = None,
                     cap: float = 0.0) -> torch.Tensor:
    """``repro.kernels.ref.flash_verify``: q ``[N, T, D]``, k, v
    ``[N, S, D]``, valid ``[N, T, S]`` -> ``[N, T, D]``."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    return grouped_attention_plain(q[:, :, None], k[:, :, None],
                                   v[:, :, None], valid, scale=scale,
                                   cap=cap)[:, :, 0]


def launch(q, k_pool, v_pool, table, start, count, mask, out, *,
           block_size: int, scale: float, cap: float) -> None:
    """Launch on PyTorch's current stream; the caller has checked every
    argument (``repro_torch.kernels.ops``).  ``mask`` is None or a
    contiguous bool ``[B, T, MB * block_size]``."""
    global launches
    b, t, h, d = q.shape
    lib = build.library("flash_verify")
    status = lib.repro_paged_verify(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        start.data_ptr(), count.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), b, t, h,
        k_pool.shape[1], d, table.shape[1], block_size,
        0 if mask is None else mask.shape[2], scale, cap,
        _DTYPE_CODE[q.dtype], build.stream_handle(q))
    build.check(status, "paged_verify")
    launches += 1
