"""Flash attention for training: the Hopper kernels
(``csrc/flash_attention.cu``), their plain PyTorch versions and their
launch counters.

Replaces the Pallas ``flash_attention`` (``repro/kernels/
flash_attention.py``), which the JAX trainer runs inside ``gqa_attention``
under ``attention_impl="pallas"``: causal, sliding-window and tanh-softcap
attention over a full sequence, in the model layout q ``[B, S, H, D]``,
k, v ``[B, S, Kv, D]`` with the GQA grouping done in the kernel.  The
forward also returns the fp32 log-sum-exp ``[B, H, S]``; the backward
(FlashAttention-2's recompute from it) has no Pallas counterpart, since
JAX differentiates the function itself.  Call them through
``repro_torch.kernels.ops``, which checks the arguments, takes the plain
versions for tensors on the CPU and wraps both in an autograd Function.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import torch

from . import build

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:204"
HEAD_DIMS = (32, 64, 128)
NEG_INF = -2.0 ** 30   # the reference's finite mask value

_BF16 = 1   # the kernels' dtype code; they take bfloat16 only
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)   # (batch, seq, head) strides
build.SIGNATURES["flash_attention"] = {
    "repro_flash_attention_fwd": (
        [_P, _S, _P, _S, _P, _S, _P, _P] + [_I] * 7 + [_F, _F, _I, _P],
        ctypes.c_int),
    "repro_flash_attention_bwd": (
        [_P, _S, _P, _S, _P, _S] + [_P] * 7 + [_I] * 7 + [_F, _F, _I, _P],
        ctypes.c_int),
}

launches = 0   # forward kernel launches since the last reset
# the backward's three kernels (Di, dK/dV, dQ) count as one launch a call
bwd = SimpleNamespace(SOURCE=SOURCE, REPLACES=REPLACES, launches=0)


def attention_mask(s: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """``[S, S]`` bool: row t sees key s where s <= t (causal) and
    t - s < window (window > 0), as the Pallas kernel's iota masks."""
    pos = torch.arange(s, device=device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def _wide(t: torch.Tensor) -> torch.Tensor:
    """fp32, or float64 for float64 inputs (gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, scale: float, cap: float):
    """fp32 scores ``[B, Kv, G, S, S]`` of q ``[B, S, H, D]`` against k
    ``[B, S, Kv, D]``, and tanh(raw / cap) when capped (else None)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = _wide(q).reshape(b, s, kvh, h // kvh, d)
    raw = torch.einsum("bqkgd,bskd->bkgqs", qg, _wide(k)) * scale
    if cap > 0:
        th = torch.tanh(raw / cap)
        return th * cap, th
    return raw, None


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None, cap: float = 0.0):
    """The forward's function: (o ``[B, S, H, D]`` in q's dtype, lse
    ``[B, H, S]`` fp32).  The Pallas kernel's order of rounding: fp32
    scores and softmax statistics, the unnormalised weights rounded to
    v's dtype before the PV product, the sum ``l`` clamped at 1e-30."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores, _ = _scores(q, k, scale, cap)
    mask = attention_mask(s, causal=causal, window=window, device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskd->bqkgd", _wide(p.to(v.dtype)), _wide(v))
    lq = l.permute(0, 3, 1, 2, 4)                         # [B, S, Kv, G, 1]
    o = (acc / torch.clamp(lq, min=1e-30)).reshape(b, s, h, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, scale: float | None = None,
                              cap: float = 0.0):
    """The backward's function, from the explicit formulas (no autograd):
    P = exp(s - lse), dV = P^T dO, dP = dO V^T, Di = rowsum(dO * O),
    dS = P * (dP - Di) * (1 - tanh^2 under a softcap), dQ = scale * dS K,
    dK = scale * dS^T Q; fp32 inside, (dq, dk, dv) in the inputs' dtypes.
    P and dS are rounded to the inputs' dtype before the products that
    take them, as the kernel (and FlashAttention-2) feed them to bf16
    tensor-core products; for fp32 or float64 inputs that is the identity."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    sc, th = _scores(q, k, scale, cap)
    mask = attention_mask(s, causal=causal, window=window, device=q.device)
    p = torch.where(mask, torch.exp(sc - lse.reshape(b, kvh, g, s, 1)), 0.0)
    dog = _wide(do).reshape(b, s, kvh, g, d)
    dv = torch.einsum("bkgqs,bqkgd->bskd", _wide(p.to(v.dtype)), dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, _wide(v))
    di = (_wide(do) * _wide(o)).sum(-1)                 # [B, S, H]
    di = di.reshape(b, s, kvh, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - di)
    if th is not None:
        ds = ds * (1 - th * th)
    ds = _wide(ds.to(q.dtype))
    qg = _wide(q).reshape(b, s, kvh, g, d)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, _wide(k)) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _strides(t: torch.Tensor):
    sb, ss, sh, _ = t.stride()
    return (ctypes.c_longlong * 3)(sb, ss, sh)


def _common(q, k, v, causal, window, scale, cap):
    b, s, h, d = q.shape
    return (q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
            v.data_ptr(), _strides(v)), \
        (b, s, h, k.shape[2], d, int(causal), window, scale, cap,
         _BF16, build.stream_handle(q))


def launch_fwd(q, k, v, out, lse, *, causal: bool, window: int,
               scale: float, cap: float) -> None:
    """Launch on PyTorch's current stream; the caller has checked every
    argument (``repro_torch.kernels.ops``).  ``out`` contiguous
    ``[B, S, H, D]``, ``lse`` contiguous fp32 ``[B, H, S]``."""
    global launches
    ptrs, rest = _common(q, k, v, causal, window, scale, cap)
    status = build.library("flash_attention").repro_flash_attention_fwd(
        *ptrs, out.data_ptr(), lse.data_ptr(), *rest)
    build.check(status, "flash_attention")
    launches += 1


def launch_bwd(q, k, v, o, lse, do, di, dq, dk, dv, *, causal: bool,
               window: int, scale: float, cap: float) -> None:
    """The three backward kernels on PyTorch's current stream.  ``o``,
    ``do``, ``dq`` contiguous ``[B, S, H, D]``; ``dk``, ``dv`` contiguous
    ``[B, S, Kv, D]``; ``lse`` and the scratch ``di`` fp32 ``[B, H, S]``."""
    ptrs, rest = _common(q, k, v, causal, window, scale, cap)
    status = build.library("flash_attention").repro_flash_attention_bwd(
        *ptrs, o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *rest)
    build.check(status, "flash_attention_bwd")
    bwd.launches += 1
