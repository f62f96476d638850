"""Public wrappers for the port's Hopper kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on
a CUDA device launches the kernel or raises.  There is no fallback from
the kernel to the plain version: an argument the kernel does not take
is an error.  Each launch adds one to its kernel module's ``launches``.
"""

from __future__ import annotations

import torch

from . import flash_decode as _fd
from . import flash_verify as _fv
from . import rmsnorm as _rms

KERNELS = {"rms_norm": _rms, "paged_decode": _fd, "paged_verify": _fv}


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
    _check_attention("paged_decode", q, k_pool, v_pool, 3)
    _check_paging("paged_decode", q.shape[0], table, block_size,
                  lengths=lengths)
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
    _check_attention("flash_decode", q3, kp, vp, 3)
    table = torch.arange(n, dtype=torch.int32, device=q.device)[:, None]
    lengths = torch.full((n,), s, dtype=torch.int32, device=q.device)
    mask = valid.expand(n, s).contiguous()
    out = torch.empty_like(q3)
    _fd.launch(q3, kp, vp, table, lengths, mask, out, block_size=s,
               scale=scale, cap=cap)
    return out.view(n, d)


def paged_verify(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
                 *, block_size: int, scale: float,
                 cap: float = 0.0) -> torch.Tensor:
    """Chunked-prefill / speculative-verify attention over the paged pool.

    q ``[B, T, H, D]``; k_pool, v_pool ``[P, Kv, D]`` (one layer's pool);
    table ``[B, MB]`` int32 physical block ids; start, count ``[B]``
    int32.  Row ``t < count[b]`` is the query at position ``start[b] +
    t`` and attends positions ``0..start[b] + t``; rows past ``count``
    come back as zeros.  Returns ``[B, T, H, D]`` in q's dtype."""
    if not _on_cuda(q, k_pool, v_pool, table, start, count):
        return _fv.paged_plain(q, k_pool, v_pool, table, start, count,
                               block_size=block_size, scale=scale, cap=cap)
    _check_attention("paged_verify", q, k_pool, v_pool, 4)
    _check_paging("paged_verify", q.shape[0], table, block_size,
                  start=start, count=count)
    out = torch.empty_like(q)
    _fv.launch(q, k_pool, v_pool, table, start, count, None, out,
               block_size=block_size, scale=scale, cap=cap)
    return out


def flash_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, *, scale: float | None = None,
                 cap: float = 0.0) -> torch.Tensor:
    """The reference's signature (``repro.kernels.ops.flash_verify``):
    q ``[N, T, D]``, k, v ``[N, S, D]``, valid bool ``[N, T, S]`` ->
    ``[N, T, D]``.  On the card it runs the paged kernel with one block
    of S positions per row, every row's causal limit at S - 1 and
    ``valid`` as its mask (inputs of another layout are copied to a
    contiguous one first)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if not _on_cuda(q, k, v, valid):
        return _fv.contiguous_plain(q, k, v, valid, scale=scale, cap=cap)
    _require(q.ndim == 3 and k.ndim == 3 and k.shape == v.shape
             and k.shape[0] == q.shape[0] and k.shape[2] == q.shape[2],
             f"flash_verify: q {tuple(q.shape)}, k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}")
    n, t, d = q.shape
    s = k.shape[1]
    _require(valid.dtype == torch.bool and valid.shape == (n, t, s),
             f"flash_verify: valid must be bool [N, T, S] = {(n, t, s)}; "
             f"got {valid.dtype} {tuple(valid.shape)}")
    q4 = q.contiguous().view(n, t, 1, d)
    kp = k.contiguous().view(n * s, 1, d)
    vp = v.contiguous().view(n * s, 1, d)
    _check_attention("flash_verify", q4, kp, vp, 4)
    table = torch.arange(n, dtype=torch.int32, device=q.device)[:, None]
    start = torch.full((n,), s - 1, dtype=torch.int32, device=q.device)
    count = torch.full((n,), t, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q4)
    _fv.launch(q4, kp, vp, table, start, count, valid.contiguous(), out,
               block_size=s, scale=scale, cap=cap)
    return out.view(n, t, d)


_Q_SHAPE = {3: "[B, H, D]", 4: "[B, T, H, D]"}


def _check_attention(name: str, q, k_pool, v_pool, q_ndim: int) -> None:
    """q ``[B, H, D]`` or ``[B, T, H, D]`` against pools ``[P, Kv, D]``
    of q's dtype."""
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
             f"{name}: dtypes q {q.dtype}, k {k_pool.dtype}, "
             f"v {v_pool.dtype} must match and be float32/bfloat16")
    _require(q.ndim == q_ndim and k_pool.ndim == 3
             and k_pool.shape == v_pool.shape,
             f"{name}: q {tuple(q.shape)} must be {_Q_SHAPE[q_ndim]} and "
             f"the pools [P, Kv, D]; got k {tuple(k_pool.shape)}, "
             f"v {tuple(v_pool.shape)}")
    h, d = q.shape[-2:]
    kvh = k_pool.shape[1]
    _require(k_pool.shape[2] == d and d in _fd.HEAD_DIMS,
             f"{name}: head_dim {d} must match the pool and be one "
             f"of {_fd.HEAD_DIMS}")
    _require(h % kvh == 0, f"{name}: {h} heads over {kvh} kv heads")
    _require(q.is_contiguous() and k_pool.is_contiguous()
             and v_pool.is_contiguous(),
             f"{name}: q and the pools must be contiguous")
    _require(all(_aligned(t) for t in (q, k_pool, v_pool)),
             f"{name}: q and the pools must be 16-byte aligned")


def _check_paging(name: str, b: int, table, block_size: int,
                  **per_slot: torch.Tensor) -> None:
    """The block table and each per-slot int32 ``[B]`` argument."""
    _require(table.dtype == torch.int32 and table.ndim == 2
             and table.shape[0] == b and table.is_contiguous(),
             f"{name}: table must be contiguous int32 [B={b}, MB]")
    for arg, t in per_slot.items():
        _require(t.dtype == torch.int32 and t.shape == (b,)
                 and t.is_contiguous(),
                 f"{name}: {arg} must be contiguous int32 [B={b}]")
    _require(block_size >= 1, f"{name}: block_size must be >= 1")
