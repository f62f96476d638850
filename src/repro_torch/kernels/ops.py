"""Public wrappers for the port's Hopper kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on
a CUDA device launches the kernel or raises.  There is no fallback from
the kernel to the plain version: an argument the kernel does not take
is an error.  Each launch adds one to its kernel module's ``launches``.
"""

from __future__ import annotations

import torch

from . import flash_decode as _fd
from . import rmsnorm as _rms

KERNELS = {"rms_norm": _rms, "paged_decode": _fd}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False when every tensor is on the CPU, True when every tensor is
    on one CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x ``[..., D]``, weight ``[D]`` -> x's shape and dtype."""
    if not _on_cuda(x, weight):
        return _rms.plain(x, weight, eps)
    d = x.shape[-1]
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"rms_norm: x dtype {x.dtype} not float32/bfloat16")
    _require(weight.dtype in (x.dtype, torch.float32),
             f"rms_norm: weight dtype {weight.dtype} for x {x.dtype}")
    _require(weight.shape == (d,), f"rms_norm: weight {tuple(weight.shape)} "
             f"for x {tuple(x.shape)}")
    _require(x.is_contiguous() and weight.is_contiguous(),
             "rms_norm: x and weight must be contiguous")
    vec = 16 // x.element_size()
    _require(d % vec == 0 and d <= _rms.max_dim(x.dtype),
             f"rms_norm: D={d} must be a multiple of {vec} and at most "
             f"{_rms.max_dim(x.dtype)}")
    _require(_aligned(x), "rms_norm: x must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel():
        _rms.launch(x.view(-1, d), weight, out.view(-1, d), eps)
    return out


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, lengths: torch.Tensor, *,
                 block_size: int, scale: float,
                 cap: float = 0.0) -> torch.Tensor:
    """Decode attention over the paged pool.

    q ``[B, H, D]``; k_pool, v_pool ``[P, Kv, D]`` (one layer's pool);
    table ``[B, MB]`` int32 physical block ids; lengths ``[B]`` int32,
    the number of leading logical positions each slot attends (its
    decode position + 1).  Returns ``[B, H, D]`` in q's dtype."""
    if not _on_cuda(q, k_pool, v_pool, table, lengths):
        return _fd.paged_plain(q, k_pool, v_pool, table, lengths,
                               block_size=block_size, scale=scale, cap=cap)
    _check_decode(q, k_pool, v_pool)
    b = q.shape[0]
    _require(table.dtype == torch.int32 and table.ndim == 2
             and table.shape[0] == b and table.is_contiguous(),
             f"paged_decode: table must be contiguous int32 [B={b}, MB]")
    _require(lengths.dtype == torch.int32 and lengths.shape == (b,)
             and lengths.is_contiguous(),
             f"paged_decode: lengths must be contiguous int32 [B={b}]")
    _require(block_size >= 1, "paged_decode: block_size must be >= 1")
    out = torch.empty_like(q)
    _fd.launch(q, k_pool, v_pool, table, lengths, None, out,
               block_size=block_size, scale=scale, cap=cap)
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, *, scale: float | None = None,
                 cap: float = 0.0) -> torch.Tensor:
    """The reference's signature (``repro.kernels.ops.flash_decode``):
    q ``[N, D]``, k, v ``[N, S, D]``, valid bool ``[S]`` or ``[N, S]``
    -> ``[N, D]``.  On the card it runs the paged kernel with one block
    of S positions per row (inputs of another layout are copied to a
    contiguous one first)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if not _on_cuda(q, k, v, valid):
        return _fd.contiguous_plain(q, k, v, valid, scale=scale, cap=cap)
    _require(q.ndim == 2 and k.ndim == 3 and k.shape == v.shape
             and k.shape[0] == q.shape[0] and k.shape[2] == q.shape[1],
             f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}")
    n, s, d = k.shape
    _require(valid.dtype == torch.bool and valid.shape in ((s,), (n, s)),
             f"flash_decode: valid must be bool [S] or [N, S]; got "
             f"{valid.dtype} {tuple(valid.shape)}")
    q3 = q.contiguous().view(n, 1, d)
    kp = k.contiguous().view(n * s, 1, d)
    vp = v.contiguous().view(n * s, 1, d)
    _check_decode(q3, kp, vp)
    table = torch.arange(n, dtype=torch.int32, device=q.device)[:, None]
    lengths = torch.full((n,), s, dtype=torch.int32, device=q.device)
    mask = valid.expand(n, s).contiguous()
    out = torch.empty_like(q3)
    _fd.launch(q3, kp, vp, table, lengths, mask, out, block_size=s,
               scale=scale, cap=cap)
    return out.view(n, d)


def _check_decode(q, k_pool, v_pool) -> None:
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
             f"paged_decode: dtypes q {q.dtype}, k {k_pool.dtype}, "
             f"v {v_pool.dtype} must match and be float32/bfloat16")
    _require(q.ndim == 3 and k_pool.ndim == 3 and k_pool.shape == v_pool.shape,
             f"paged_decode: q {tuple(q.shape)} must be [B, H, D] and the "
             f"pools [P, Kv, D]; got k {tuple(k_pool.shape)}, "
             f"v {tuple(v_pool.shape)}")
    _, h, d = q.shape
    kvh = k_pool.shape[1]
    _require(k_pool.shape[2] == d and d in _fd.HEAD_DIMS,
             f"paged_decode: head_dim {d} must match the pool and be one "
             f"of {_fd.HEAD_DIMS}")
    _require(h % kvh == 0, f"paged_decode: {h} heads over {kvh} kv heads")
    _require(q.is_contiguous() and k_pool.is_contiguous()
             and v_pool.is_contiguous(),
             "paged_decode: q and the pools must be contiguous")
    _require(all(_aligned(t) for t in (q, k_pool, v_pool)),
             "paged_decode: q and the pools must be 16-byte aligned")
