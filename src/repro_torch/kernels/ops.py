"""Public wrappers for the port's Hopper kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on
a CUDA device launches the kernel or raises.  There is no fallback from
the kernel to the plain version: an argument the kernel does not take
is an error.  Each launch adds one to its kernel's ``launches`` counter
(``KERNELS``).  The training path reaches the kernels through two
autograd Functions, ``rms_norm_fn`` and ``flash_attention``, whose
backward passes are kernels too; ``matmul`` is reached through
``HopperBackend`` by every ``ops.matmul`` of the core stack, forward and
tape backward.
"""

from __future__ import annotations

import math

import torch

from . import flash_attention as _fa
from . import flash_decode as _fd
from . import flash_verify as _fv
from . import matmul as _mm
from . import rmsnorm as _rms

# name -> the object whose ``launches`` counts that kernel's launches
KERNELS = {"rms_norm": _rms, "rms_norm_bwd": _rms.bwd,
           "paged_decode": _fd, "paged_verify": _fv,
           "flash_attention": _fa, "flash_attention_bwd": _fa.bwd,
           "matmul": _mm}


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


def _check_rms(name: str, x: torch.Tensor, weight: torch.Tensor) -> None:
    d = x.shape[-1]
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"{name}: x dtype {x.dtype} not float32/bfloat16")
    _require(weight.dtype in (x.dtype, torch.float32),
             f"{name}: weight dtype {weight.dtype} for x {x.dtype}")
    _require(weight.shape == (d,), f"{name}: weight {tuple(weight.shape)} "
             f"for x {tuple(x.shape)}")
    _require(x.is_contiguous() and weight.is_contiguous(),
             f"{name}: x and weight must be contiguous")
    vec = 16 // x.element_size()
    _require(d % vec == 0 and d <= _rms.max_dim(x.dtype),
             f"{name}: D={d} must be a multiple of {vec} and at most "
             f"{_rms.max_dim(x.dtype)}")
    _require(_aligned(x), f"{name}: x must be 16-byte aligned")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``torch.matmul``'s semantics (1-D operands, batch
    dimensions broadcast), float32 or bfloat16 in any mix, accumulated in
    fp32 and returned in ``promote_types(a, b)``.  Operands are read
    through their strides (transposed and broadcast views are not
    copied); any M, N, K."""
    if not _on_cuda(a, b):
        return _mm.plain(a, b)
    _require(a.dtype in _mm.DTYPES and b.dtype in _mm.DTYPES,
             f"matmul: dtypes {a.dtype} @ {b.dtype}; the kernel takes "
             "float32 and bfloat16")
    _require(a.ndim >= 1 and b.ndim >= 1, "matmul: 0-d operand")
    _require(not _needs_grad(a, b),
             "matmul: the kernel has no torch autograd; differentiate it "
             "with the tape (core.autograd.functions.matmul), not "
             "torch.autograd or torch.func")
    a2 = a if a.ndim > 1 else a[None]
    b2 = b if b.ndim > 1 else b[:, None]
    m, k = a2.shape[-2:]
    n = b2.shape[-1]
    _require(b2.shape[-2] == k, f"matmul: shapes {tuple(a.shape)} @ "
             f"{tuple(b.shape)} do not contract")
    lead = torch.broadcast_shapes(a2.shape[:-2], b2.shape[:-2])
    out = torch.empty(*lead, m, n, dtype=torch.promote_types(a.dtype,
                                                             b.dtype),
                      device=a.device)
    if out.numel():
        rows = _fold_rows(a2) if b2.ndim == 2 else None
        if rows is not None:      # [..., M, K] @ [K, N]: one product
            _mm_launch(rows, b2, out.view(-1, n), (), (), ())
        else:
            ae = a2.expand(*lead, m, k)
            be = b2.expand(*lead, k, n)
            sizes, sa, sb = _batch_dims(lead, ae.stride()[:-2],
                                        be.stride()[:-2])
            if len(sizes) > _mm.MAX_BATCH_DIMS:   # materialize the batch
                ae = ae.reshape(-1, m, k)
                be = be.reshape(-1, k, n)
                sizes, sa, sb = ((ae.shape[0],), ae.stride()[:1],
                                 be.stride()[:1])
            _mm_launch(ae, be, out.view(-1, m, n), sizes, sa, sb)
    if b.ndim == 1:
        out = out.squeeze(-1)
    if a.ndim == 1:
        out = out.squeeze(-2 if b.ndim > 1 else -1)
    return out


def _fold_rows(a: torch.Tensor) -> torch.Tensor | None:
    """``a`` ``[..., M, K]`` as a ``[M', K]`` view when its leading
    dimensions fold into its rows without a copy, else None."""
    try:
        return a.view(-1, a.shape[-1])
    except RuntimeError:
        return None


def _batch_dims(sizes, sa, sb):
    """Drop size-1 batch dimensions and merge neighbours that step
    uniformly in both operands; returns (sizes, a strides, b strides)."""
    out = [(s, x, y) for s, x, y in zip(sizes, sa, sb) if s != 1]
    merged: list[tuple[int, int, int]] = []
    for s, x, y in out:
        if merged:
            ps, px, py = merged[-1]
            if px == x * s and py == y * s:
                merged[-1] = (ps * s, x, y)
                continue
        merged.append((s, x, y))
    return (tuple(t[0] for t in merged), tuple(t[1] for t in merged),
            tuple(t[2] for t in merged))


def _mm_launch(a, b, c, sizes, sa, sb) -> None:
    """Launch the kernel for A ``[.., M, K]``, B ``[.., K, N]`` and the
    contiguous C, with up to three batch dimensions (sizes and strides
    of each operand)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    pad = _mm.MAX_BATCH_DIMS - len(sizes)
    batch = (1,) * pad + tuple(sizes)
    nz = math.prod(batch)
    _require(nz <= _mm.MAX_GRID_YZ
             and -(-m // _mm.TILE_M) <= _mm.MAX_GRID_YZ,
             f"matmul: {nz} batches of {m} rows exceed the grid")
    _mm.launch(a, (a.stride(-2), a.stride(-1)) + (0,) * pad + tuple(sa),
               b, (b.stride(-2), b.stride(-1)) + (0,) * pad + tuple(sb),
               c, m, n, k, batch)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x ``[..., D]``, weight ``[D]`` -> x's shape and dtype."""
    if not _on_cuda(x, weight):
        return _rms.plain(x, weight, eps)
    _check_rms("rms_norm", x, weight)
    d = x.shape[-1]
    out = torch.empty_like(x)
    if x.numel():
        _rms.launch(x.view(-1, d), weight, out.view(-1, d), eps)
    return out


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The RMSNorm backward: (dx in x's shape and dtype, dw ``[D]`` in
    weight's dtype) from x, weight and the output's gradient dy."""
    if not _on_cuda(x, weight, dy):
        return _rms.bwd_plain(x, weight, dy, eps)
    _require(dy.shape == x.shape and dy.dtype == x.dtype,
             f"rms_norm_bwd: dy {dy.dtype} {tuple(dy.shape)} must match x "
             f"{x.dtype} {tuple(x.shape)}")
    dy = dy.contiguous()
    _check_rms("rms_norm_bwd", x, weight)
    _require(_aligned(dy), "rms_norm_bwd: dy must be 16-byte aligned")
    d = x.shape[-1]
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, dw.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(rows, 4 * sms)
    dw_part = torch.empty(blocks, d, dtype=torch.float32, device=x.device)
    _rms.launch_bwd(x.view(-1, d), weight, dy.view(-1, d), dx.view(-1, d),
                    dw, dw_part, eps)
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """RMSNorm whose forward and backward are the kernels (their plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, dy, ctx.eps)
        return dx, dw, None


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rms_norm_fn(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Differentiable ``rms_norm``: the model's norms go through here.
    Without a gradient to take (serving) it calls the forward directly,
    sparing the autograd Function's host overhead."""
    if not _needs_grad(x, weight):
        return rms_norm(x, weight, eps)
    return _RMSNorm.apply(x, weight, eps)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, cap: float = 0.0):
    """Full-sequence attention in the model layout: q ``[B, S, H, D]``,
    k, v ``[B, S, Kv, D]`` -> (o ``[B, S, H, D]`` in q's dtype, lse
    ``[B, H, S]`` fp32).  Query row t sees keys s <= t (causal) with
    t - s < window (window > 0); the scale defaults to 1/sqrt(D)."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    if not _on_cuda(q, k, v):
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, scale=scale, cap=cap)
    _check_flash("flash_attention", q, k, v, window)
    b, s, h, d = q.shape
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _fa.launch_fwd(q, k, v, out, lse, causal=causal, window=window,
                   scale=scale, cap=cap)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None,
                        cap: float = 0.0):
    """The gradient of ``flash_attention_fwd``'s o: (dq, dk, dv) in the
    inputs' shapes and dtypes, from the forward's o and lse and the
    output gradient do."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    if not _on_cuda(q, k, v, o, lse, do):
        return _fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal, window=window,
                                             scale=scale, cap=cap)
    _check_flash("flash_attention_bwd", q, k, v, window)
    b, s, h, d = q.shape
    _require(o.shape == q.shape and do.shape == q.shape
             and o.dtype == q.dtype and do.dtype == q.dtype,
             f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and do "
             f"{tuple(do.shape)} {do.dtype} must match q")
    _require(lse.shape == (b, h, s) and lse.dtype == torch.float32
             and lse.is_contiguous(),
             f"flash_attention_bwd: lse must be contiguous float32 "
             f"[{b}, {h}, {s}]")
    o, do = o.contiguous(), do.contiguous()
    _require(_aligned(o) and _aligned(do),
             "flash_attention_bwd: o and do must be 16-byte aligned")
    dq = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    di = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _fa.launch_bwd(q, k, v, o, lse, do, di, dq, dk, dv, causal=causal,
                   window=window, scale=scale, cap=cap)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the kernels (their plain
    versions on the CPU); saves q, k, v, o and the fp32 lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, cap):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     scale=scale, cap=cap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale, cap=cap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """The reference's signature (``repro.kernels.ops.flash_attention``):
    q ``[B, S, H, D]``, k, v ``[B, S, Kv, D]`` (GQA grouped in the kernel,
    no repeat) -> ``[B, S, H, D]``; differentiable (without a gradient
    to take, only the forward runs and nothing is saved)."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    if not _needs_grad(q, k, v):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   scale=scale, cap=softcap)[0]
    return _FlashAttention.apply(q, k, v, causal, window, scale, softcap)


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


def _check_flash(name: str, q, k, v, window: int) -> None:
    """q ``[B, S, H, D]``, k and v ``[B, S, Kv, D]`` in bfloat16 (the
    kernels' one dtype, the model's training dtype), every row contiguous
    along D and 16-byte aligned."""
    _require(q.dtype == torch.bfloat16
             and k.dtype == q.dtype and v.dtype == q.dtype,
             f"{name}: dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} must "
             "all be bfloat16 on the card")
    _require(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape
             and k.shape[:2] == q.shape[:2] and k.shape[3] == q.shape[3],
             f"{name}: q {tuple(q.shape)} must be [B, S, H, D] and k, v "
             f"[B, S, Kv, D]; got k {tuple(k.shape)}, v {tuple(v.shape)}")
    h, d = q.shape[2], q.shape[3]
    _require(d in _fa.HEAD_DIMS,
             f"{name}: head_dim {d} must be one of {_fa.HEAD_DIMS}")
    _require(h % k.shape[2] == 0, f"{name}: {h} heads over {k.shape[2]} "
             "kv heads")
    _require(window >= 0, f"{name}: window {window} must be >= 0")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        _require(t.stride(3) == 1 and all(st % vec == 0
                                          for st in t.stride()[:3]),
                 f"{name}: q, k, v must be contiguous along D with "
                 f"(batch, seq, head) strides in multiples of {vec}; got "
                 f"strides {t.stride()}")
        _require(_aligned(t), f"{name}: q, k, v must be 16-byte aligned")
