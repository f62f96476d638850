#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases, each of which raises (non-zero exit) on failure:
  1. print the card's name and power limit; build the five CUDA sources
     from ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the main paths give it (paged_verify at a
     prefill chunk, T=128, and at a speculative verify, T=5; the
     training kernels at B=4, S=2048, H=Kv=32, D=128, causal, and
     rms_norm_bwd at [8192, 4096]; plus a GQA and a window + softcap
     attention shape for correctness; matmul in fp32 at [4096, 768] @
     [768, 3072], at the ragged [4096, 768] @ [768, 30522] and at a
     tape-backward a^T @ g with K = 4096, and in bf16, against its plain
     version with TF32 off);
  3. time each kernel, its plain version and one PyTorch call for the
     same function (a yardstick the port never calls);
  4. serve codeqwen1.5-7b at full width (random weights from --seed,
     bf16) through ``ServeEngine`` on the paged cache: 8 requests with
     prompts of 128..1024 tokens and 64 new tokens each, counting every
     kernel launch of that run; then the same requests again with
     speculative decoding on (n-gram proposer, k=4), counting again;
     then four more plain runs that time the decode step with the
     projections through ``ops.dot_general`` and through a direct
     ``torch.matmul``, in turns;
     then train codeqwen1.5-7b at full width, depth cut from 32 to 4
     layers, for 16 AdamW steps of batch 4 x 2048 tokens through
     ``repro_torch.training.train`` (remat "full", flash attention),
     counting launches again, and restore its checkpoint bit for bit;
  5. hold the card's first decode logits and verify logits of a 2-layer
     full-width model against the port on the CPU (plain versions, fp32
     from the same bf16 weights), and the loss and three gradients of a
     training batch likewise; check that ``LM.forward`` runs the
     flash-attention kernel, and that the speculative engine emits the
     plain engine's tokens on the card (2 layers, fp32);
  6. Flashlight's core stack under ``repro_torch.session(backend=
     "hopper")``: a BERT-base-width transformer (12 layers, d 768, 12
     heads, vocab 30522, fp32, batch 8 x 512 from the ported data
     pipeline) trained through the tape for 10 SGD-momentum steps, every
     matmul of its forward and backward on the Hopper matmul kernel, its
     first step held against ``backend="torch"`` (cuBLAS, TF32 off); the
     paper's quickstart CNN at its own size (``val_err < 20``); and the
     backend-swap demo (a counting backend under the full-width 2-layer
     codeqwen1.5-7b forward, a hopper matmul, a session kernel override).
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # H100 SXM fp32 peak outside the tensor cores

# bf16 tolerances, |kernel - plain| <= ATOL + RTOL * |plain|:
# RMSNorm: both round one fp32 result to bf16, so they differ by at most
#   one or two bf16 ulps (2^-7 relative each) from the summation order;
# decode and verify: the plain versions round the softmax weights to
#   bf16 before the PV product (the reference's order), the kernels keep
#   them fp32; outputs are averages of unit-scale values.
RMS_TOL = (1e-6, 2.0 ** -6)
DECODE_TOL = (1e-2, 2.0 ** -6)
VERIFY_TOL = DECODE_TOL
# full-width 2-layer logits, card bf16 vs CPU fp32 on the same weights:
# logits have a spread of ~1.3; bf16 rounding through two layers and the
# bf16-rounded unembedding stays well inside 0.1.
LOGITS_ATOL = 0.1
# flash attention in bf16 against its plain version, which rounds P (and,
# in the backward, dS) to bf16 before the products that take them, as the
# kernels do: the two differ in summation order and where such a rounding
# flips, about one bf16 ulp (2^-8) of a few entries.  Outputs are
# averages of ~N(0,1) values, ~0.03 at late rows and keys, so an absolute
# tolerance alone would pass a zeroed tile.  Each of o, dq, dk, dv is
# held by its relative L2 error (ATTN_REL_TOL) and each of its rows (one
# position and head, D values) by the row's L2 error over its norm plus
# 1 % of the median row norm (ATTN_ROW_TOL; dQ of position 0 is ~0), so
# an error confined to a few late query or key tiles fails.  The forward
# is also held elementwise, as decode.  rms_norm dw sums 8192 rows in
# fp32 partials: one bf16 ulp (2^-7) plus 1e-3.
ATTN_TOL = DECODE_TOL
ATTN_REL_TOL = 1e-2
ATTN_ROW_TOL = 5e-2
DW_TOL = (1e-3, 2.0 ** -7)
# the softcap shape uses cap 2 on ~N(0,1) scores, where tanh is far from
# linear; its plain output and gradients must differ from the uncapped
# ones by more than ten times ATTN_REL_TOL, or the check could not see a
# kernel that ignored the cap or its derivative.
SOFTCAP = 2.0
# 2-layer full-width training batch, card bf16 vs CPU fp32 on the same
# bf16 weights: a dozen bf16 roundings of 2^-9 relative on the way
# through two layers forward and back add up to ~1 %; the loss (~11.4)
# to 0.05 absolute and each gradient's relative L2 error to 0.05.
TRAIN_LOSS_ATOL = 0.05
TRAIN_GRAD_RTOL = 0.05
H100_PEAK = "989 TFLOP/s bf16 dense (H100 SXM data sheet)"
# token identity, speculative vs plain engine on the card in fp32: the
# two paths sum in other orders (5-row vs 1-row matmuls, the verify vs
# the decode kernel), which moves fp32 logits of spread ~1.3 by ~1e-5;
# only where the plain run's top two logits are closer than this bound
# may the greedy token differ.
MARGIN_BOUND = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def time_ms(fn, iters: int = 20, replays: int = 10,
            graph: bool = True) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so host overhead
    does not hide the device time of a small kernel.  ``graph=False``
    times ``iters * replays`` plain calls between the events instead,
    for calls of milliseconds whose temporaries are large."""
    fn()
    torch.cuda.synchronize()
    if not graph:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters * replays):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * replays)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, flops: float,
          peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 ------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build(["rmsnorm", "flash_decode", "flash_verify",
                         "flash_attention", "matmul"])
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or (
                    "spill" in line and "0 bytes spill stores" not in line):
                log(f"[build] {name}: {line.strip()}")


# -- phases 2 and 3 -----------------------------------------------------------

def decode_inputs(gen, *, batch=8, heads=32, kv_heads=32, head_dim=128,
                  block_size=16, max_seq=2048):
    """A paged pool as serving lays it out: ragged lengths up to max_seq,
    blocks scattered over the pool, unmapped entries on the trash block
    0, and an inactive row (table of zeros, length 1)."""
    mb = max_seq // block_size
    num_blocks = batch * mb + 1
    dev = "cuda"
    lengths = torch.tensor([2048, 1537, 1024, 700, 129, 33, 16, 1][:batch],
                           dtype=torch.int32)
    perm = torch.randperm(num_blocks - 1, generator=gen) + 1
    table = torch.zeros(batch, mb, dtype=torch.int32)
    used = 0
    for b in range(batch - 1):            # the last row stays inactive
        n = -(-int(lengths[b]) // block_size)
        table[b, :n] = perm[used:used + n]
        used += n
    pool = num_blocks * block_size
    shape = (pool, kv_heads, head_dim)
    k = torch.randn(shape, generator=gen).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen).to(torch.bfloat16)
    q = torch.randn(batch, heads, head_dim, generator=gen).to(torch.bfloat16)
    return (q.to(dev), k.to(dev), v.to(dev), table.to(dev), lengths.to(dev),
            block_size)


def kernel_checks(seed: int) -> list[dict]:
    """Phase 2 and 3: correctness at main-path shapes, then timings."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops, rmsnorm

    gen = torch.Generator().manual_seed(seed)
    rows = []

    # RMSNorm: decode rows [8, 4096] and one prefill chunk [8 * 128, 4096]
    w = (1 + 0.1 * torch.randn(4096, generator=gen)).to(torch.bfloat16).cuda()
    rms_err = 0.0
    for n in (8, 8 * 128):
        x = torch.randn(n, 4096, generator=gen).to(torch.bfloat16).cuda()
        rms_err = max(rms_err, check_close(
            f"rms_norm[{n},4096]", ops.rms_norm(x, w), rmsnorm.plain(x, w),
            *RMS_TOL))
    log(f"[check] rms_norm bf16 max abs err {rms_err:.3e}")
    x = torch.randn(8, 4096, generator=gen).to(torch.bfloat16).cuda()
    nbytes = 2 * x.numel() * 2 + w.numel() * 2
    b_ms, b_by = bound(nbytes, 4 * x.numel())
    rows.append({
        "name": "rms_norm", "route": "cuda", "source": rmsnorm.SOURCE,
        "replaces": rmsnorm.REPLACES, "shape": "x[8,4096] bf16",
        "max_abs_err": rms_err,
        "ms": time_ms(lambda: ops.rms_norm(x, w)),
        "plain_ms": time_ms(lambda: rmsnorm.plain(x, w)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.rms_norm(x, (4096,), w, 1e-6))})
    xp = torch.randn(8 * 128, 4096, generator=gen).to(torch.bfloat16).cuda()
    log(f"[time] rms_norm[1024,4096] kernel "
        f"{time_ms(lambda: ops.rms_norm(xp, w)):.5f} ms, F.rms_norm "
        f"{time_ms(lambda: F.rms_norm(xp, (4096,), w, 1e-6)):.5f} ms, "
        f"bound {bound(2 * xp.numel() * 2 + 8192, 0)[0]:.5f} ms")

    # paged decode at the serving shapes (B=8, H=Kv=32, D=128)
    q, k, v, table, lengths, bs = decode_inputs(gen)
    scale = 1 / math.sqrt(q.shape[-1])

    def kernel():
        return ops.paged_decode(q, k, v, table, lengths, block_size=bs,
                                scale=scale)

    def plain():
        return fd.paged_plain(q, k, v, table, lengths, block_size=bs,
                              scale=scale)

    dec_err = check_close("paged_decode", kernel(), plain(), *DECODE_TOL)
    # GQA grouping and softcap, which the main config does not reach
    qg = q[:, :32].contiguous()
    kg, vg = k[:, :8].contiguous(), v[:, :8].contiguous()
    check_close("paged_decode gqa+softcap",
                ops.paged_decode(qg, kg, vg, table, lengths, block_size=bs,
                                 scale=scale, cap=5.0),
                fd.paged_plain(qg, kg, vg, table, lengths, block_size=bs,
                               scale=scale, cap=5.0), *DECODE_TOL)
    # the reference's contiguous signature with a per-row validity mask
    qc, kc, vc = q[:, 0], k[:8 * 256, 0].reshape(8, 256, 128), \
        v[:8 * 256, 0].reshape(8, 256, 128)
    valid = torch.rand(8, 256, generator=gen).cuda() < 0.5
    valid[3] = False                        # a row with no valid key
    out_c = ops.flash_decode(qc, kc, vc, valid)
    check_close("flash_decode contiguous", out_c,
                fd.contiguous_plain(qc, kc, vc, valid), *DECODE_TOL)
    if bool(out_c[3].abs().max() != 0):
        raise AssertionError("flash_decode: a fully masked row must be 0")
    log(f"[check] paged_decode bf16 max abs err {dec_err:.3e} "
        f"(lengths {lengths.tolist()})")

    n_pos = int(lengths.sum())
    kvh, d = k.shape[1], k.shape[2]
    nbytes = (2 * n_pos * kvh * d * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + lengths.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * n_pos * q.shape[1] * d)
    idx = fd.paged_read_index(table, bs)
    kg_view = k[idx].transpose(1, 2).contiguous()      # [B, Kv, L, D]
    vg_view = v[idx].transpose(1, 2).contiguous()
    pos = torch.arange(idx.shape[1], device="cuda")
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    rows.append({
        "name": "paged_decode", "route": "cuda", "source": fd.SOURCE,
        "replaces": fd.REPLACES,
        "shape": f"q[8,32,128] bf16, {n_pos} cached positions, block 16",
        "max_abs_err": dec_err, "ms": time_ms(kernel),
        "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kg_view, vg_view, attn_mask=mask, scale=scale))})

    # T=1 through the verify kernel is the decode kernel's function
    check_close("paged_verify T=1 vs paged_decode",
                ops.paged_verify(q[:, None].contiguous(), k, v, table,
                                 lengths - 1, torch.ones_like(lengths),
                                 block_size=bs, scale=scale)[:, 0],
                kernel(), *DECODE_TOL)
    rows.append(verify_checks(gen))
    for r in rows:
        for at in (r, r.get("at_verify_shape")):
            if at:
                log(f"[time] {r['name']} {at['shape']}: kernel "
                    f"{at['ms']:.5f} ms, plain {at['plain_ms']:.5f} ms, "
                    f"library {at['library_ms']:.5f} ms, bound "
                    f"{at['bound_ms']:.5f} ms ({at['bound_by']})")
    return rows


PROMPT_LENS = [128 + (1024 - 128) * i // 7 for i in range(8)]


def verify_inputs(gen, start, count, *, t, heads=32, kv_heads=32,
                  head_dim=128, block_size=16, max_seq=2048):
    """q ``[B, T, H, D]`` and a paged pool whose rows are mapped up to
    ``start + count`` through scattered blocks; a row of count 0 keeps a
    table of zeros."""
    batch, mb = len(start), max_seq // block_size
    num_blocks = batch * mb + 1
    perm = torch.randperm(num_blocks - 1, generator=gen) + 1
    table = torch.zeros(batch, mb, dtype=torch.int32)
    used = 0
    for b in range(batch):
        n = -(-(start[b] + count[b]) // block_size) if count[b] else 0
        table[b, :n] = perm[used:used + n]
        used += n
    shape = (num_blocks * block_size, kv_heads, head_dim)
    k = torch.randn(shape, generator=gen).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen).to(torch.bfloat16)
    q = torch.randn(batch, t, heads, head_dim,
                    generator=gen).to(torch.bfloat16)
    ints = dict(dtype=torch.int32, device="cuda")
    return (q.cuda(), k.cuda(), v.cuda(), table.cuda(),
            torch.tensor(start, **ints), torch.tensor(count, **ints),
            block_size)


def verify_checks(gen) -> dict:
    """paged_verify at a prefill chunk (T=128: each prompt's last chunk,
    ragged starts 0..896) and at a speculative verify (T=5: counts 0 and
    1..5), plus GQA with softcap and the reference's contiguous
    signature; each timed beside its bound, its plain version and SDPA
    with a boolean mask on a pre-gathered view."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_verify as fv
    from repro_torch.kernels import ops

    shapes = {
        "prefill": ([(n - 2) // 128 * 128 for n in PROMPT_LENS],
                    [n - 1 - (n - 2) // 128 * 128 for n in PROMPT_LENS], 128),
        "verify": ([0] + [n + 20 for n in PROMPT_LENS[1:]],
                   [0, 1, 2, 3, 4, 5, 5, 5], 5)}
    out, err = {}, 0.0
    for name, (start, count, t) in shapes.items():
        q, k, v, table, st, ct, bs = verify_inputs(gen, start, count, t=t)
        d = q.shape[-1]
        kw = dict(block_size=bs, scale=1 / math.sqrt(d))

        def kernel():
            return ops.paged_verify(q, k, v, table, st, ct, **kw)

        def plain():
            return fv.paged_plain(q, k, v, table, st, ct, **kw)

        got = kernel()
        err = max(err, check_close(f"paged_verify {name}", got, plain(),
                                   *VERIFY_TOL))
        pad = torch.arange(t, device="cuda")[None, :] >= ct[:, None]
        if bool(got[pad].any()):
            raise AssertionError(f"paged_verify {name}: padding rows and "
                                 "idle slots must be 0")
        # GQA (32 heads over 8) with the tanh softcap
        kg, vg = k[:, :8].contiguous(), v[:, :8].contiguous()
        check_close(f"paged_verify {name} gqa+softcap",
                    ops.paged_verify(q, kg, vg, table, st, ct, **kw,
                                     cap=5.0),
                    fv.paged_plain(q, kg, vg, table, st, ct, **kw, cap=5.0),
                    *VERIFY_TOL)
        # bound: K/V read once up to each row's causal limit
        n_pos = sum(s + c for s, c in zip(start, count) if c)
        n_rows = sum(count)
        h, kvh = q.shape[2], k.shape[1]
        nbytes = (2 * n_pos * kvh * d * 2 + n_rows * h * d * 2
                  + q.numel() * 2 + table.numel() * 4 + 8 * len(start))
        flops = 4 * h * d * sum(s * c + c * (c + 1) // 2
                                for s, c in zip(start, count))
        b_ms, b_by = bound(nbytes, flops)
        idx = fv.paged_read_index(table, bs)
        kview = k[idx].transpose(1, 2).contiguous()      # [B, Kv, L, D]
        vview = v[idx].transpose(1, 2).contiguous()
        mask = fv.verify_valid(st, ct, t, idx.shape[1])[:, None]
        qt = q.transpose(1, 2)                           # [B, H, T, D]
        out[name] = {
            "shape": f"q[8,{t},32,128] bf16, starts {start}, counts "
                     f"{count}, block 16",
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kview, vview, attn_mask=mask, scale=kw["scale"]))}

    # the reference's contiguous signature with the sweep's staircase
    n, t, s, d = 4, 5, 512, 128
    qc, kc, vc = (torch.randn(*sh, generator=gen).to(torch.bfloat16).cuda()
                  for sh in ((n, t, d), (n, s, d), (n, s, d)))
    starts = torch.tensor([1, 40, 100, s - t], device="cuda")
    valid = (torch.arange(s, device="cuda")[None, None, :]
             <= starts[:, None, None]
             + torch.arange(t, device="cuda")[None, :, None])
    valid[2, 3] = False                       # a row with no valid key
    got = ops.flash_verify(qc, kc, vc, valid)
    check_close("flash_verify contiguous", got,
                fv.contiguous_plain(qc, kc, vc, valid), *VERIFY_TOL)
    if bool(got[2, 3].abs().max() != 0):
        raise AssertionError("flash_verify: a fully masked row must be 0")
    log(f"[check] paged_verify bf16 max abs err {err:.3e} (prefill T=128 "
        f"and verify T=5; GQA+softcap, T=1 and contiguous entry agree)")
    return {"name": "paged_verify", "route": "cuda", "source": fv.SOURCE,
            "replaces": fv.REPLACES, "max_abs_err": err, **out["prefill"],
            "at_verify_shape": out["verify"]}


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rms_norm_bwd",
                 "matmul")
TRAIN_SHAPE = dict(b=4, s=2048, h=32, kv=32, d=128)


def rel_err(got, want) -> tuple[float, float]:
    """(relative L2 error of the whole tensor, worst row's L2 error over
    its norm plus 1 % of the median row norm); rows run along the last
    dimension."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    diff = (got - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    return (float(diff.norm() / norm.norm()),
            float((diff / (norm + 0.01 * norm.median())).max()))


def check_rel(name: str, got, want) -> tuple[float, float]:
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    whole, row = rel_err(got, want)
    if not (whole <= ATTN_REL_TOL and row <= ATTN_ROW_TOL):
        raise AssertionError(
            f"{name}: relative L2 error {whole:.3e} (limit {ATTN_REL_TOL}), "
            f"worst row {row:.3e} (limit {ATTN_ROW_TOL})")
    return whole, row


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs a causal / window mask admits in one head."""
    t = torch.arange(s)
    lo = (t - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(t)
    hi = t if causal else torch.full_like(t, s - 1)
    return int((hi - lo + 1).sum())


def training_kernel_checks(gen) -> list[dict]:
    """Phase 2 and 3 for the training kernels: flash_attention forward
    and backward at the training shape (B=4, S=2048, H=Kv=32, D=128,
    causal), a GQA shape and a window + softcap shape (correctness
    only), and rms_norm_bwd at [8192, 4096]; each timed beside its
    bound, its plain version and one PyTorch call."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, rmsnorm

    def bf16(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16).cuda()

    def attn_case(b, s, h, kv, d, **kw):
        q, k, v, do = bf16(b, s, h, d), bf16(b, s, kv, d), bf16(b, s, kv, d), \
            bf16(b, s, h, d)
        kw = dict(kw, scale=1 / math.sqrt(d))
        o, lse = ops.flash_attention_fwd(q, k, v, **kw)
        want_o, want_lse = fa.flash_attention_plain(q, k, v, **kw)
        tag = f"[{b},{s},{h},{d}] kv={kv} {kw}"
        err = check_close(f"flash_attention {tag}", o, want_o, *ATTN_TOL)
        rels = [check_rel(f"flash_attention {tag}", o, want_o)]
        check_close(f"flash_attention lse {tag}", lse, want_lse, 1e-3, 1e-5)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        names = ("dq", "dk", "dv")
        rels += [check_rel(f"flash_attention_bwd {n} {tag}", g, w)
                 for n, g, w in zip(names, got, want)]
        gerr = max(float((g.float() - w.float()).abs().max())
                   for g, w in zip(got, want))
        if kw.get("cap"):
            kw0 = dict(kw, cap=0.0)
            o0, lse0 = fa.flash_attention_plain(q, k, v, **kw0)
            want0 = fa.flash_attention_bwd_plain(q, k, v, o0, lse0, do, **kw0)
            gaps = {n: rel_err(w0, w)[0] for n, w0, w in
                    zip(("o",) + names, (o0,) + want0, (want_o,) + want)}
            log(f"[check] softcap {kw['cap']}: relative L2 distance of the "
                f"capped from the uncapped plain outputs {gaps}")
            if min(gaps.values()) <= 10 * ATTN_REL_TOL:
                raise AssertionError(f"softcap {kw['cap']} moves the "
                                     f"function too little: {gaps}")
            del o0, lse0, want0
        log(f"[check] flash_attention {tag}: relative L2 error / worst row "
            + ", ".join(f"{n} {w:.2e} / {r:.2e}"
                        for n, (w, r) in zip(("o",) + names, rels)))
        del want_o, want_lse, got, want
        torch.cuda.empty_cache()
        return (q, k, v, o, lse, do, kw), err, gerr

    b, s, h, kv, d = (TRAIN_SHAPE[x] for x in ("b", "s", "h", "kv", "d"))
    (q, k, v, o, lse, do, kw), f_err, b_err = attn_case(b, s, h, kv, d,
                                                        causal=True)
    g_errs = attn_case(2, 1024, 32, 8, 128, causal=True)[1:]
    w_errs = attn_case(2, 512, 8, 8, 128, causal=True, window=128,
                       cap=SOFTCAP)[1:]
    log(f"[check] flash_attention bf16 max abs err {f_err:.3e}, backward "
        f"{b_err:.3e} at [4,2048,32,128] causal; GQA (Kv=8) {g_errs[0]:.3e} "
        f"/ {g_errs[1]:.3e}; window 128 + softcap {SOFTCAP} "
        f"{w_errs[0]:.3e} / {w_errs[1]:.3e}")

    pairs = attention_pairs(s, True, 0) * b * h
    io = q.numel() * 2
    shape = f"q,k,v[4,2048,32,128] bf16 causal ({pairs} attended pairs)"
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    kw_sdpa = dict(is_causal=True, scale=kw["scale"])
    fwd_bound = bound(4 * io + lse.numel() * 4, 4 * d * pairs)
    rows = [{
        "name": "flash_attention", "route": "cuda", "source": fa.SOURCE,
        "replaces": fa.REPLACES, "shape": shape, "max_abs_err": f_err,
        "ms": time_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw),
                      iters=5, replays=2, graph=False),
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                            iters=2, replays=1, graph=False),
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **kw_sdpa), iters=5, replays=2, graph=False)}]

    def sdpa_fwd_bwd():
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        out = F.scaled_dot_product_attention(*leaves, **kw_sdpa)
        return torch.autograd.grad(out, leaves, dot)

    # FlashAttention-2's count: S, dP, dV, dQ, dK = 5 products of 2D each
    bwd_bound = bound(5 * io + 3 * io + lse.numel() * 4, 10 * d * pairs)
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": fa.SOURCE,
        "replaces": fa.REPLACES, "shape": shape + ", dO bf16",
        "max_abs_err": b_err,
        "ms": time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                      **kw),
                      iters=3, replays=2, graph=False),
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), iters=1, replays=1, graph=False),
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "library_ms": time_ms(sdpa_fwd_bwd, iters=3, replays=2,
                              graph=False),
        "library": "F.scaled_dot_product_attention forward + backward"})
    del q, k, v, o, lse, do, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # rms_norm backward at the training batch's rows
    x, dy = bf16(8192, 4096), bf16(8192, 4096)
    w = (1 + 0.1 * torch.randn(4096, generator=gen)).to(torch.bfloat16).cuda()
    dx, dw = ops.rms_norm_bwd(x, w, dy)
    want_dx, want_dw = rmsnorm.bwd_plain(x, w, dy)
    r_err = max(check_close("rms_norm_bwd dx", dx, want_dx, *RMS_TOL),
                check_close("rms_norm_bwd dw", dw, want_dw, *DW_TOL))
    log(f"[check] rms_norm_bwd bf16 [8192,4096] max abs err {r_err:.3e}")
    library_ms = None
    fused = getattr(torch.ops.aten, "_fused_rms_norm_backward", None)
    if fused is not None:
        _, rstd = torch.ops.aten._fused_rms_norm(x, [4096], w, 1e-6)
        library_ms = time_ms(lambda: fused(dy, x, [4096], rstd, w,
                                           [True, True]))
    rb = bound(3 * x.numel() * 2 + 2 * w.numel() * 2, 10 * x.numel())
    rows.append({
        "name": "rms_norm_bwd", "route": "cuda", "source": rmsnorm.SOURCE,
        "replaces": rmsnorm.REPLACES, "shape": "x, dy [8192,4096] bf16",
        "max_abs_err": r_err,
        "ms": time_ms(lambda: ops.rms_norm_bwd(x, w, dy)),
        "plain_ms": time_ms(lambda: rmsnorm.bwd_plain(x, w, dy), iters=5,
                            replays=2, graph=False),
        "bound_ms": rb[0], "bound_by": rb[1], "library_ms": library_ms,
        "library": "aten._fused_rms_norm_backward"})
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        log(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.5f} ms, "
            f"plain {r['plain_ms']:.5f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


# -- phase 4 ------------------------------------------------------------------

def full_width_model(seed: int):
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config("codeqwen1.5-7b")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"random bf16 weights from seed {seed} in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params


def make_requests(vocab: int, rng):
    """8 requests with prompts of 128..1024 tokens drawn from ``rng`` and
    64 new tokens each."""
    from repro_torch.serving import Request

    return [Request(uid=i, prompt=torch.randint(
        vocab, (n,), generator=rng).tolist(), max_new_tokens=64)
        for i, n in enumerate(PROMPT_LENS)]


def serve(model, params, seed: int, *, speculative: bool,
          profile_steps: int = 0, stats: dict | None = None) -> dict[str, int]:
    """One serve run of the 8 requests, plain or speculative (n-gram,
    k=4); returns the kernel launches of that run alone and puts its
    decode ms per step (per round) into ``stats``."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServingPolicy
    from repro_torch.serving import Request, ServeEngine

    cfg = model.cfg
    tag = "spec" if speculative else "serve"
    policy = ServingPolicy(cache="paged", block_size=16, prefill_chunk=128,
                           speculative={"enabled": speculative, "k": 4})
    engine = ServeEngine(model, params, batch_slots=8, max_seq=2048,
                         policy=policy)

    prefill_s = [0.0]
    step = type(model).prefill_step

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(model, *a, **kw)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return out

    model.prefill_step = timed_prefill
    try:
        rng = torch.Generator().manual_seed(seed + 1)
        # warm-up request: first cuBLAS calls and the kernels' first
        # launches
        engine.submit(Request(uid=-1, prompt=torch.randint(
            cfg.vocab_size, (40,), generator=rng).tolist(),
            max_new_tokens=4))
        engine.run_until_done()
        prefill_s[0] = 0.0
        reqs = make_requests(cfg.vocab_size, rng)
        torch.cuda.synchronize()
        calls0 = (engine.prefill_calls, engine.decode_calls,
                  engine.verify_calls, engine.spec_rounds)
        accepted0 = engine.accepted_tokens
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        done = engine.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        del model.prefill_step

    if len(done) != len(reqs) or any(
            len(r.generated) != 64 or not all(0 <= t < cfg.vocab_size
                                              for t in r.generated)
            for r in done):
        raise AssertionError(f"{tag}: every request must finish with 64 "
                             "tokens in the vocabulary")
    n_prefill = engine.prefill_calls - calls0[0]
    n_decode = engine.decode_calls - calls0[1]
    n_verify = engine.verify_calls - calls0[2]
    n_rounds = engine.spec_rounds - calls0[3]
    path = (("rms_norm", "paged_verify") if speculative
            else ("rms_norm", "paged_decode", "paged_verify"))
    for name in path:
        if counts[name] == 0:
            raise AssertionError(f"{tag}: kernel {name} was never launched")
    if any(counts[name] for name in TRAIN_KERNELS):
        raise AssertionError(f"{tag}: serving launched a training kernel: "
                             f"{counts}")
    if counts["paged_verify"] != cfg.n_layers * (n_prefill + n_verify):
        raise AssertionError(
            f"{tag}: {counts['paged_verify']} paged_verify launches for "
            f"{n_prefill} prefill and {n_verify} verify calls of "
            f"{cfg.n_layers} layers")
    if engine.kv.blocks_in_use != 0:
        raise AssertionError(f"{tag}: {engine.kv.blocks_in_use} blocks "
                             "still in use after every request finished")
    if speculative and engine.decode_calls != 0:
        raise AssertionError(f"spec: {engine.decode_calls} plain decode "
                             "calls; every step must go through verify")
    n_prompt = sum(len(r.prompt) for r in reqs)
    n_gen = sum(len(r.generated) for r in reqs)
    decode_s = wall - prefill_s[0]
    ttft = sorted(r.first_token_time - r.submit_time for r in reqs)
    steps = n_rounds if speculative else n_decode
    if stats is not None:
        stats["decode_ms"] = 1e3 * decode_s / steps
    log(f"[{tag}] {len(done)} requests, {n_prompt} prompt tokens, {n_gen} "
        f"generated in {wall:.3f} s ({n_prefill} prefill chunk calls, "
        f"{n_decode} decode steps, {n_verify} verify calls, "
        f"{engine.preemptions} preemptions)")
    log(f"[{tag}] prefill {n_prompt / prefill_s[0]:.1f} tokens/s "
        f"({prefill_s[0]:.3f} s); decode {n_gen / decode_s:.1f} tokens/s "
        f"({decode_s:.3f} s, {1e3 * decode_s / steps:.2f} ms per "
        f"{'round' if speculative else 'step'} at 8 slots); TTFT p50 "
        f"{ttft[len(ttft) // 2]:.3f} s")
    if speculative:
        spec = engine.describe()["speculative"]
        log(f"[spec] {n_verify} verify calls, "
            f"{(engine.accepted_tokens - accepted0) / n_rounds:.3f} accepted "
            f"tokens per round, {spec['accepted_per_step']} tokens per slot "
            f"per round (whole engine), decode_calls "
            f"{engine.decode_calls}, blocks_in_use "
            f"{engine.kv.blocks_in_use}, rollback blocks freed "
            f"{engine.kv.rollback_blocks_freed}")
    log(f"[{tag}] launches {counts}; paged_verify per prefill chunk call "
        f"and per verify call: {cfg.n_layers}")
    log(f"[{tag}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile_steps and not speculative:
        profile_serve(engine, reqs, profile_steps)
    return counts


def profile_serve(engine, reqs, steps: int) -> None:
    """Trace a refilled engine with torch.profiler in two windows: the
    admission step (every prefill chunk call and the first decode step)
    and then ``steps`` decode steps.  Prints device time by kernel and
    the device's busy share of each window (kernels run on one stream,
    so their times add)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    for r in reqs:
        engine.submit(Request(uid=100 + r.uid, prompt=r.prompt,
                              max_new_tokens=steps + 2))
    torch.cuda.synchronize()
    calls0 = engine.prefill_calls
    for label, n in (("admission", 1), ("decode", steps)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                engine.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if label == "admission":
            label = (f"admission step ({engine.prefill_calls - calls0} "
                     f"prefill chunk calls + 1 decode step)")
        else:
            label = f"{n} decode steps at 8 slots"
        report_profile(prof, label, n, wall_us)
    engine.run_until_done()


def kernel_group(name: str) -> str:
    """A device kernel's group by its name: the port's kernels, cuBLAS
    matmuls, PyTorch's elementwise / copy / reduction kernels, the rest."""
    if "fa_fwd" in name or "fa_bwd" in name:
        return "flash attention (port)"
    if "paged_" in name:
        return "paged attention (port)"
    if "rmsnorm" in name:
        return "rms_norm (port)"
    if "mm_f32_kernel" in name or "mm_bf16_kernel" in name:
        return "matmul (port)"
    if any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma", "cublas")):
        return "matmul (cuBLAS)"
    if "at::native" in name:
        return "elementwise, copies, reductions (PyTorch)"
    return "other"


def report_profile(prof, label: str, n: int, wall_us: float,
                   detail: bool = True) -> float:
    """Print the window's device busy time and, with ``detail``, its
    kernels and host ops by time; returns the busy microseconds."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return (getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels)
    if not busy:
        log(f"[profile] {label}: the profiler reported no device time")
        return 0.0
    log(f"[profile] {label}: {wall_us / n:.0f} us/step on the host clock, "
        f"device busy {busy / n:.0f} us/step "
        f"({100 * busy / wall_us:.1f} % of the window)")
    groups: dict[str, list] = {}
    for e in kernels:
        g = groups.setdefault(kernel_group(e.key), [0.0, 0])
        g[0] += dev_us(e)
        g[1] += e.count
    for name, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   group {name}: {us / n:9.1f} us/step "
            f"({100 * us / busy:.1f} % of busy), {count / n:.0f} launches/step")
    if not detail:
        return busy
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"[profile]   {dev_us(e) / n:9.1f} us/step  "
            f"{e.count // n:4d} launches/step  {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CPU]
    log("[profile] host ops by self time (profiler on, which adds its "
        "own cost to each op):")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"[profile]   {e.self_cpu_time_total / n:9.1f} us/step  "
            f"{e.count // n:4d} calls/step  {e.key[:90]}")
    return busy


TRAIN_LAYERS = 4       # codeqwen1.5-7b has 32; cut so AdamW state fits
# AdamW at lr 1e-3 after a 2-step warmup lifts the loss of this random
# full-width model from 12.2 to ~21 by step 4 before it falls (8 steps end
# at 11.1, 16 steps at ~5.7), so the run takes 16 steps for the loss to
# show it learns.
TRAIN_STEPS = 16
CKPT_DIR = ROOT / ".smoke_ckpt"   # listed in .gitignore; removed after use


def train_config(layers: int):
    from repro_torch.configs import get_config

    return get_config("codeqwen1.5-7b").with_(
        n_layers=layers, attention_impl="pallas", remat="full")


def model_flops(cfg, params, b: int, s: int) -> float:
    """Model flops of one training step: 6 N per token for the N
    parameters of every matmul (all but the embedding table, which is a
    lookup), plus attention's 3 x 4 D per attended pair per head (forward
    QK^T and PV, backward twice that); remat's recompute not counted."""
    from repro_torch.models.meta import tree_leaves

    n = sum(p.numel() for p in tree_leaves(params)) - params["embed"].numel()
    attn = (3 * 4 * cfg.resolved_head_dim * attention_pairs(s, True, 0)
            * b * cfg.n_heads * cfg.n_layers)
    return 6.0 * n * b * s + attn


def train_phase(seed: int, profile_steps: int) -> dict[str, int]:
    """Train 4-layer full-width codeqwen1.5-7b for 16 steps through
    ``repro_torch.training.train`` (AdamW lr 1e-3, cosine warmup 2, clip
    1.0, remat "full", flash attention, batch 4 x 2048 from the ported
    ``make_batches``), counting kernel launches of that run; then
    restore the run's checkpoint into a fresh model bit for bit, and
    profile two more steps.  Returns the launches of the run."""
    import shutil

    from repro_torch.core.optim import AdamW
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_batches
    from repro_torch.models import LM
    from repro_torch.models.meta import tree_leaves
    from repro_torch.training import CheckpointManager, TrainConfig, train
    from repro_torch.training.train_loop import make_step_fn

    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    cfg = train_config(TRAIN_LAYERS)
    model = LM(cfg)
    params = model.init(seed)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"[train] {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, kv "
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16), "
        f"depth cut from 32 to {cfg.n_layers} layers: {n_params / 1e9:.3f} B "
        f"params; random weights from seed {seed}")
    batches = list(make_batches(cfg, b, s, TRAIN_STEPS + 2, seed=seed))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    tcfg = TrainConfig(steps=TRAIN_STEPS, base_lr=1e-3, warmup=2,
                       grad_clip=1.0, checkpoint_dir=str(CKPT_DIR),
                       checkpoint_every=10 ** 9, log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, hist = train(model, params, iter(batches[:TRAIN_STEPS]), tcfg,
                         optimizer=AdamW(lr=1e-3), log_fn=log)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    if not (losses[-1] + losses[-2]) / 2 < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    per_step = {"flash_attention": 2 * cfg.n_layers,     # forward + remat
                "flash_attention_bwd": cfg.n_layers,
                "rms_norm": 2 * (2 * cfg.n_layers) + 1,  # final norm once
                "rms_norm_bwd": 2 * cfg.n_layers + 1,
                "paged_decode": 0, "paged_verify": 0, "matmul": 0}
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    flops = model_flops(cfg, params, b, s)
    steady = [h["sec"] for h in hist[2:]]
    step_s = sum(steady) / len(steady)
    for h in hist:
        log(f"[train] step {h['step']}: {1e3 * h['sec']:.1f} ms, "
            f"{b * s / h['sec']:.1f} tokens/s, loss {h['loss']:.4f}")
    log(f"[train] steps 2..{TRAIN_STEPS - 1}: {1e3 * step_s:.2f} ms per step, "
        f"{b * s / step_s:.1f} tokens/s, MFU {100 * flops / step_s / BF16_FLOPS:.2f} % "
        f"({flops / 1e12:.2f} TFLOP of model flops per step over {H100_PEAK}); "
        f"peak device memory {peak:.2f} GiB")
    log(f"[train] launches per step {per_step} (x {TRAIN_STEPS} steps)")

    # the run's checkpoint, restored into a fresh model
    ckpt = CheckpointManager(CKPT_DIR)
    fresh = LM(cfg).init(seed + 1)
    t0 = time.perf_counter()
    (restored, state), extra = ckpt.restore(
        (fresh, AdamW(lr=1e-3).init(fresh)))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b_) for a, b_ in
               zip(tree_leaves(restored), tree_leaves(params)))
    if extra.get("step") != TRAIN_STEPS or not same:
        raise AssertionError(f"train: checkpoint step {extra} or parameters "
                             "differ from the trained ones")
    log(f"[train] checkpoint of step {extra['step']} restored into a fresh "
        f"model bit for bit ({time.perf_counter() - t0:.1f} s)")
    del fresh, restored, state
    shutil.rmtree(CKPT_DIR, ignore_errors=True)

    # device busy share: two more steps under the profiler
    opt = AdamW(lr=1e-3)
    step_fn = make_step_fn(model, opt, tcfg)
    state = opt.init(params)
    profile_train(step_fn, params, state, batches[TRAIN_STEPS:], step_s,
                  model.device, detail=profile_steps > 0)
    return counts


def profile_train(step_fn, params, state, batches, step_s, device,
                  detail: bool) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.device import host_to_device

    dev_batches = [{k: host_to_device(v, device) for k, v in b.items()}
                   for b in batches]
    step_fn(params, state, 0, dev_batches[0])     # outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(dev_batches):
            _, _, m = step_fn(params, state, 1 + i, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(dev_batches)
    busy = report_profile(prof, f"{n} training steps", n, wall_us,
                          detail=detail)
    if busy:
        log(f"[train] device busy {busy / n / 1e3:.2f} ms per step: "
            f"{100 * busy / n / 1e6 / step_s:.1f} % of an unprofiled step "
            f"({1e3 * step_s:.2f} ms)")


# -- phase 5 ------------------------------------------------------------------

def two_layer_config(dtype):
    from repro_torch.configs import get_config

    return get_config("codeqwen1.5-7b").with_(
        n_layers=2, param_dtype=dtype, compute_dtype=dtype)


def logits_parity(seed: int) -> float:
    """The card's first decode logits and the verify logits of the next
    5 tokens (bf16) against the port on the CPU (fp32, same weights)."""
    from repro_torch.models import LM
    from repro_torch.models.meta import tree_map
    from repro_torch.serving import BlockTable

    cfg = two_layer_config(torch.bfloat16)
    gpu = LM(cfg)
    params = gpu.init(seed)
    prompt = torch.randint(cfg.vocab_size, (1, 44),
                           generator=torch.Generator().manual_seed(seed + 2))

    def logits(model, p):
        cache = model.init_paged_cache(1, 64, num_blocks=5, block_size=16)
        bt = BlockTable(torch.tensor([[1, 2, 3, 4]], dtype=torch.int32,
                                     device=model.device), 16)
        model.prefill_step(p, cache, prompt[:, :39], [0], [39],
                           block_table=bt)
        dec, _ = model.decode_step(p, cache, prompt[:, 39:40], [39],
                                   block_table=bt)
        ver, _ = model.verify_step(p, cache, prompt[:, 39:44], [39], [5],
                                   block_table=bt)
        return dec.float().cpu(), ver.float().cpu()

    card = logits(gpu, params)
    cpu_cfg = two_layer_config(torch.float32)
    cpu_params = tree_map(lambda t: t.float().cpu(), params)
    del params
    torch.cuda.empty_cache()
    ref = logits(LM(cpu_cfg, device="cpu"), cpu_params)
    err = 0.0
    for what, c, r in zip(("decode", "verify"), card, ref):
        e = float((c - r).abs().max())
        same = bool((c.argmax(-1) == r.argmax(-1)).all())
        log(f"[parity] 2-layer full-width {what} logits {tuple(c.shape)}: "
            f"max abs err {e:.4f} (limit {LOGITS_ATOL}), logit std "
            f"{float(r.std()):.3f}, argmax "
            f"{'agrees' if same else 'differs'}")
        if not bool(torch.isfinite(c).all()) or e > LOGITS_ATOL:
            raise AssertionError(f"parity: card {what} logits disagree "
                                 "with the CPU")
        err = max(err, e)
    return err


def train_parity(seed: int) -> dict[str, int]:
    """A 2-layer full-width training batch (B=1, S=256): the card in bf16
    against the port on the CPU in fp32 from the same bf16 weights, on
    the loss and the gradients of ``final_norm.scale``, the last layer's
    ``wo`` and the batch's embedding rows.  Also counts the launches of
    one ``LM.forward`` on the card, which must run flash attention."""
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.meta import tree_leaves, tree_map

    cfg = train_config(2)
    gpu = LM(cfg)
    params = gpu.init(seed)
    rng = torch.Generator().manual_seed(seed + 4)
    tokens = torch.randint(cfg.vocab_size, (1, 256), generator=rng)
    batch = {"tokens": tokens,
             "labels": torch.randint(cfg.vocab_size, (1, 256), generator=rng)}

    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _, _ = gpu.forward(params, tokens)
    torch.cuda.synchronize()
    forward = ops.launch_counts()
    if (forward["flash_attention"] != cfg.n_layers
            or forward["paged_decode"] or forward["paged_verify"]
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"LM.forward on the card: launches {forward}")
    log(f"[parity] LM.forward on the card: launches {forward}")
    del logits

    def grads(model, p):
        for t in tree_leaves(p):
            t.requires_grad_(True)
        loss, _ = model.loss_fn(p, batch)
        loss.backward()
        out = [float(loss.detach()), p["final_norm"]["scale"].grad,
               p["stages"][0]["attn"]["wo"].grad[-1],
               p["embed"].grad[tokens[0].to(p["embed"].device)]]
        return [out[0]] + [g.float().cpu() for g in out[1:]]

    card = grads(gpu, params)
    cpu_params = tree_map(lambda t: t.detach().float().cpu(), params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = grads(LM(cfg.with_(param_dtype=torch.float32,
                             compute_dtype=torch.float32), device="cpu"),
                cpu_params)
    host_s = time.perf_counter() - t0
    loss_err = abs(card[0] - ref[0])
    log(f"[parity] 2-layer full-width training batch [1,256]: loss card "
        f"{card[0]:.5f} vs CPU {ref[0]:.5f} (|diff| {loss_err:.5f}, limit "
        f"{TRAIN_LOSS_ATOL}); CPU reference {host_s:.1f} s")
    bad = loss_err > TRAIN_LOSS_ATOL or not math.isfinite(card[0])
    for name, c, r in zip(("final_norm.scale", "stages[0].attn.wo[-1]",
                           "embed[tokens]"), card[1:], ref[1:]):
        rel = float((c - r).norm() / r.norm())
        log(f"[parity]   grad {name} {tuple(c.shape)}: relative L2 error "
            f"{rel:.4f} (limit {TRAIN_GRAD_RTOL}), norm {float(r.norm()):.4e}")
        bad = bad or not rel <= TRAIN_GRAD_RTOL
    if bad:
        raise AssertionError("parity: the card's training batch disagrees "
                             "with the CPU")
    return forward


def token_identity(seed: int) -> None:
    """Plain and speculative engines on a 2-layer full-width fp32 model
    on the card emit the same tokens, but where the plain run's top two
    logits are within MARGIN_BOUND (read from the port's forward on the
    CPU in fp32, from the same weights)."""
    from repro_torch.models import LM
    from repro_torch.models.meta import tree_map
    from repro_torch.runtime import ServingPolicy
    from repro_torch.serving import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 matmuls
    cfg = two_layer_config(torch.float32)
    model = LM(cfg)
    params = model.init(seed)
    streams = {}
    for spec in (False, True):
        engine = ServeEngine(model, params, batch_slots=8, max_seq=2048,
                             policy=ServingPolicy(
                                 cache="paged", block_size=16,
                                 prefill_chunk=128,
                                 speculative={"enabled": spec, "k": 4}))
        reqs = make_requests(cfg.vocab_size,
                             torch.Generator().manual_seed(seed + 3))
        for r in reqs:
            engine.submit(r)
        engine.run_until_done()
        streams[spec] = {r.uid: (r.prompt, r.generated) for r in reqs}
        if spec:
            d = engine.describe()["speculative"]
            log(f"[identity] speculative run: {d['verify_calls']} verify "
                f"calls, {d['accepted_tokens']} accepted, "
                f"{d['rejected_tokens']} rejected, decode_calls "
                f"{engine.decode_calls}")
    diverged, cpu = 0, None
    for uid, (prompt, plain) in streams[False].items():
        spec = streams[True][uid][1]
        i = next((j for j, (a, b) in enumerate(zip(plain, spec)) if a != b),
                 None)
        if i is None:
            if len(plain) != len(spec):
                raise AssertionError(f"identity: request {uid} emitted "
                                     f"{len(spec)} tokens, not {len(plain)}")
            continue
        diverged += 1
        if cpu is None:   # the flash-attention kernels take bf16 only
            cpu = (LM(cfg, device="cpu"),
                   tree_map(lambda t: t.cpu(), params))
        logits, _, _ = cpu[0].forward(cpu[1],
                                      torch.tensor([prompt + plain[:i]]))
        top2 = torch.topk(logits[0, -1], 2).values
        margin = float(top2[0] - top2[1])
        log(f"[identity] request {uid}: first divergence at generated "
            f"token {i} (plain {plain[i]}, speculative {spec[i]}), plain "
            f"top-two margin {margin:.3e} (bound {MARGIN_BOUND})")
        if margin >= MARGIN_BOUND:
            raise AssertionError("identity: the speculative engine "
                                 "changed a token the plain run chose by "
                                 f"a margin of {margin:.3e}")
    log(f"[identity] 2-layer full-width fp32: {len(streams[False])} "
        f"requests x 64 tokens, {len(streams[False]) - diverged} identical "
        f"to the plain run, {diverged} diverged within the margin bound")


# -- matmul (phases 2 and 3) --------------------------------------------------

# matmul against its plain version (fp32 products with TF32 off, then one
# rounding to the promoted dtype), held by the relative L2 error of the
# whole product and of its worst row and worst column (each over its norm
# plus 1 % of the median), so a zeroed or misplaced edge tile fails: fp32
# sums in another order (~sqrt(K) x 2^-24 relative) to 1e-5 whole and
# 1e-4 per row / column; a bf16 output is one bf16 rounding (2^-9
# relative) from the plain one, to 1e-2 and 5e-2.
MM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 5e-2)}
FP32_PEAK = "67 TFLOP/s fp32 outside the tensor cores (H100 SXM data sheet)"


def check_mm(name: str, got, want) -> tuple[float, float]:
    """(relative L2 error, worst row or column) of a product."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    whole_tol, row_tol = MM_TOL[got.dtype]
    errs = [rel_err(g, w) for g, w in
            ((got, want), (got.transpose(-1, -2), want.transpose(-1, -2)))]
    whole, worst = max(e[0] for e in errs), max(e[1] for e in errs)
    if not (whole <= whole_tol and worst <= row_tol):
        raise AssertionError(
            f"{name}: relative L2 error {whole:.3e} (limit {whole_tol}), "
            f"worst row / column {worst:.3e} (limit {row_tol})")
    return whole, worst


def matmul_checks(gen) -> dict:
    """Phase 2 and 3 for matmul at the core stack's shapes: fp32 [4096,
    768] @ [768, 3072] (a BERT-base MLP projection over 8 x 512 tokens),
    the ragged fp32 [4096, 768] @ [768, 30522] (its vocabulary head), the
    tape's weight gradient a^T @ g with K = 4096 (a transposed view), and
    bf16 at the first shape; each timed beside its bound (fp32 against
    the CUDA cores' fp32 peak, bf16 against the tensor cores'), its plain
    version and ``torch.matmul`` (TF32 off for both)."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops

    f32, bf16 = torch.float32, torch.bfloat16

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen).to(dtype).cuda()

    cases = [
        ("fp32 [4096,768] @ [768,3072]",
         lambda: (rand(4096, 768), rand(768, 3072))),
        ("bf16 [4096,768] @ [768,3072]",
         lambda: (rand(4096, 768, dtype=bf16), rand(768, 3072, dtype=bf16))),
        ("fp32 ragged [4096,768] @ [768,30522]",
         lambda: (rand(4096, 768), rand(768, 30522))),
        ("fp32 a^T @ g: [4096,768]^T (a view) @ [4096,3072], K=4096",
         lambda: (rand(4096, 768).t(), rand(4096, 3072))),
    ]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        for shape, make in cases:
            a, b = make()
            got, want = ops.matmul(a, b), mm.plain(a, b)
            whole, worst = check_mm(f"matmul {shape}", got, want)
            err = float((got.float() - want.float()).abs().max())
            m, k = a.shape
            n = b.shape[1]
            nbytes = (a.numel() * a.element_size() + b.numel()
                      * b.element_size() + m * n * got.element_size())
            peak = BF16_FLOPS if got.dtype == bf16 else FP32_FLOPS
            b_ms, b_by = bound(nbytes, 2.0 * m * n * k, peak)
            out.append({
                "shape": shape, "max_abs_err": err, "rel_l2": whole,
                "worst_row_or_col": worst,
                "ms": time_ms(lambda: ops.matmul(a, b), iters=5, replays=2,
                              graph=False),
                "plain_ms": time_ms(lambda: mm.plain(a, b), iters=5,
                                    replays=2, graph=False),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_peak": FP32_PEAK if peak == FP32_FLOPS else H100_PEAK,
                "library_ms": time_ms(lambda: torch.matmul(a, b), iters=5,
                                      replays=2, graph=False)})
            del a, b, got, want
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for r in out:
        log(f"[check] matmul {r['shape']}: relative L2 error "
            f"{r['rel_l2']:.2e}, worst row / column {r['worst_row_or_col']:.2e}, "
            f"max abs err {r['max_abs_err']:.3e}")
        log(f"[time] matmul {r['shape']}: kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, torch.matmul {r['library_ms']:.5f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, {r['bound_peak']})")
    return {"name": "matmul", "route": "cuda", "source": mm.SOURCE,
            "replaces": mm.REPLACES, **out[0],
            "max_abs_err": max(r["max_abs_err"] for r in out),
            "library": "torch.matmul (cuBLAS, TF32 off)",
            "at_other_shapes": out[1:]}


# -- phase 6: Flashlight's core stack -------------------------------------------

# BERT-base's published widths (arXiv:1810.04805): the ``bert_like`` family
# of the reference's overhead benchmark at full size
CORE_SHAPE = dict(d=768, heads=12, layers=12, vocab=30522, b=8, s=512)
CORE_STEPS = 10
# SGD momentum 0.9 without warmup diverged at lr 0.01 and above on this
# random model (reduced-depth rehearsals on the CPU); 0.002 falls steadily
CORE_LR = 0.002
# first step under hopper against torch (cuBLAS, TF32 off), both fp32 on
# the same weights: sums in other orders move the loss by ~1e-7 relative
# and the gradients by ~1e-6; the loss to 1e-4 relative, each gradient
# leaf by its relative L2 error to 1e-3.  A leaf whose gradient is below a
# thousandth of the global norm (the key biases, whose exact gradient is
# zero) is held against that floor, since both sides are rounding noise.
CORE_LOSS_RTOL = 1e-4
CORE_GRAD_RTOL = 1e-3
CORE_GRAD_FLOOR = 1e-3


def core_batches(seed: int, n: int):
    """``n`` batches of 8 x 512 byte tokens from the ported data pipeline
    (synthetic corpus, packed, shuffled), on the card."""
    import types

    from repro_torch.launch.train import make_batches

    cfg = types.SimpleNamespace(family="dense", vocab_size=CORE_SHAPE["vocab"])
    return [(torch.from_numpy(x["tokens"]).long().cuda(),
             torch.from_numpy(x["labels"]).long().cuda())
            for x in make_batches(cfg, CORE_SHAPE["b"], CORE_SHAPE["s"], n,
                                  seed=seed)]


def core_agreement(model, batch) -> None:
    """First-step loss and gradients under ``hopper`` (the matmul
    kernel) against ``torch`` (cuBLAS, TF32 off) on the same weights."""
    import repro_torch
    from repro_torch.core.tensor import HopperBackend

    named = dict(model.container.named_params())
    res = {}
    for name, backend in (("torch", "torch"), ("hopper", HopperBackend())):
        with repro_torch.session(backend=backend):
            model.container.zero_grad()
            loss = model.loss(*batch)
            loss.backward()
            res[name] = (float(loss.data),
                         {k: v.grad for k, v in named.items()})
    model.container.zero_grad()
    (ref_loss, ref), (loss, got) = res["torch"], res["hopper"]
    gnorm = float(torch.sqrt(sum(g.double().square().sum()
                                 for g in ref.values())))
    worst, worst_name = 0.0, ""
    for k, want in ref.items():
        err = float((got[k].double() - want.double()).norm()
                    / max(float(want.double().norm()),
                          CORE_GRAD_FLOOR * gnorm))
        if err > worst:
            worst, worst_name = err, k
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    log(f"[core] first step, hopper vs torch (TF32 off), same weights: loss "
        f"{loss:.6f} vs {ref_loss:.6f} (relative {loss_err:.2e}, limit "
        f"{CORE_LOSS_RTOL}); worst gradient leaf {worst_name}: relative L2 "
        f"error {worst:.2e} (limit {CORE_GRAD_RTOL}) over {len(ref)} leaves")
    if not (loss_err <= CORE_LOSS_RTOL and worst <= CORE_GRAD_RTOL
            and math.isfinite(loss)):
        raise AssertionError("core: the hopper backend's first step "
                             "disagrees with the torch backend's")


def core_phase(seed: int, profile_steps: int) -> dict[str, int]:
    """Train the BERT-base-width core stack through the tape under
    ``session(backend="hopper")`` for ``CORE_STEPS`` SGD-momentum steps,
    counting kernel launches of that run; returns them."""
    import repro_torch
    from repro_torch.core.optim import SGD
    from repro_torch.core.tensor import HopperBackend
    from repro_torch.kernels import ops
    from repro_torch.launch.tape_transformer import TapeTransformer

    c = CORE_SHAPE
    b, s = c["b"], c["s"]
    t0 = time.perf_counter()
    model = TapeTransformer(c["d"], c["heads"], c["layers"], c["vocab"],
                            seed=seed, device="cuda")
    params = model.container.params()
    n_params = sum(p.data.numel() for p in params)
    batches = core_batches(seed, CORE_STEPS + 3)
    log(f"[core] BERT-base width: {c['layers']} x TransformerBlock("
        f"{c['d']}, {c['heads']}) (ff {4 * c['d']}, LayerNorm, GELU), "
        f"Embedding / Linear({c['vocab']}), fp32: {n_params / 1e6:.1f} M "
        f"params from seed {seed} ({time.perf_counter() - t0:.1f} s); batch "
        f"{b} x {s}; SGD lr {CORE_LR} momentum 0.9")
    core_agreement(model, batches[0])

    backend = HopperBackend()
    per_step = model.matmuls_per_step()
    with repro_torch.session(backend=backend, tag="core-bert-base") as sess:
        opt = SGD(params, lr=CORE_LR, momentum=0.9)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, secs = [], []
        for toks, labels in batches[:CORE_STEPS]:
            t0 = time.perf_counter()
            loss = model.loss(toks, labels)
            loss.backward()
            opt.step()
            opt.zeroGrad()
            losses.append(float(loss.data))      # the step's one read-back
            secs.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[core] session {json.dumps(sess.describe()['backend'])}, tag "
            f"{sess.tag!r}")
    want = {k: 0 for k in counts}
    want["matmul"] = per_step * CORE_STEPS
    if counts != want or backend.fallback_calls != 0 \
            or backend.kernel_calls != want["matmul"]:
        raise AssertionError(
            f"core: launches {counts}, expected {want}; hopper backend "
            f"kernel_calls {backend.kernel_calls}, fallback_calls "
            f"{backend.fallback_calls}")
    if not all(math.isfinite(x) for x in losses) or not \
            (losses[-1] + losses[-2]) / 2 < losses[0]:
        raise AssertionError(f"core: the loss did not fall: {losses}")
    d, v, L = c["d"], c["vocab"], c["layers"]
    flops = 3 * 2 * b * s * (L * (12 * d * d + 2 * s * d) + d * v)
    step_s = sum(secs[1:]) / len(secs[1:])
    for i, (loss, sec) in enumerate(zip(losses, secs)):
        log(f"[core] step {i}: {1e3 * sec:.1f} ms, loss {loss:.4f}")
    log(f"[core] steps 1..{CORE_STEPS - 1}: {1e3 * step_s:.2f} ms per step, "
        f"{b * s / step_s:.1f} tokens/s; matmul {flops / 1e12:.3f} TFLOP per "
        f"step ({flops / step_s / 1e12:.2f} TFLOP/s over the step); "
        f"{per_step} matmul launches per step, fallback_calls 0; peak device "
        f"memory {peak:.2f} GiB")
    profile_core(model, opt, backend, batches[CORE_STEPS:], step_s,
                 detail=profile_steps > 0)
    del model, params, opt, batches
    torch.cuda.empty_cache()
    return counts


def profile_core(model, opt, backend, batches, step_s, detail) -> None:
    """The device's busy share of core steps: one step outside the
    window, then the rest under torch.profiler."""
    import repro_torch
    from torch.profiler import ProfilerActivity, profile

    def step(toks, labels):
        loss = model.loss(toks, labels)
        loss.backward()
        opt.step()
        opt.zeroGrad()
        return float(loss.data)

    with repro_torch.session(backend=backend):
        step(*batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for toks, labels in batches[1:]:
                step(toks, labels)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    n = len(batches) - 1
    busy = report_profile(prof, f"{n} core steps", n, wall_us, detail=detail)
    if busy:
        log(f"[core] device busy {busy / n / 1e3:.2f} ms per step: "
            f"{100 * busy / n / 1e6 / step_s:.1f} % of an unprofiled step "
            f"({1e3 * step_s:.2f} ms)")


def quickstart_phase() -> dict[str, int]:
    """The paper's quickstart (``examples/quickstart.py``) at its own size
    under ``hopper``: 28 batches of 64 a epoch, 4 epochs, SGD momentum;
    its two Linear layers run the matmul kernel (six launches a training
    batch, two an evaluation batch)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, val_err = quickstart.run(backend="hopper", device="cuda",
                                log=lambda m: log(f"[quickstart] {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}
    want["matmul"] = 4 * (28 * 6 + 4 * 2)
    log(f"[quickstart] {wall:.2f} s for 4 epochs; launches {counts}")
    if counts != want or not val_err < 20.0:
        raise AssertionError(f"quickstart: validation error {val_err:.2f} % "
                             f"(limit 20), launches {counts}, expected {want}")
    return counts


def swap_demo(seed: int) -> None:
    """``examples/swap_backend.py`` steps 1, 3 and 4 (step 2, the lazy
    backend, comes with the compiler): a counting backend sees every
    projection of the full-width 2-layer codeqwen1.5-7b forward, the
    hopper backend runs ``ops.matmul`` on the kernel, and a session kernel
    override intercepts exactly one call."""
    import repro_torch
    from repro_torch.core.tensor import HopperBackend, TorchBackend, ops
    from repro_torch.kernels import matmul as mm
    from repro_torch.models import LM

    class CountingBackend(TorchBackend):
        name = "counting"

        def __init__(self):
            self.counts = {}

        def _bump(self, op):
            self.counts[op] = self.counts.get(op, 0) + 1

        def add(self, lhs, rhs):
            self._bump("add")
            return super().add(lhs, rhs)

        def matmul(self, lhs, rhs):
            self._bump("matmul")
            return super().matmul(lhs, rhs)

        def dot_general(self, lhs, rhs, dimension_numbers,
                        preferred_element_type):
            self._bump("dot_general")
            return super().dot_general(lhs, rhs, dimension_numbers,
                                       preferred_element_type)

    cfg = two_layer_config(torch.bfloat16)
    model = LM(cfg)
    params = model.init(seed)
    toks = torch.zeros(1, 16, dtype=torch.long, device="cuda")
    with repro_torch.session(backend=CountingBackend(),
                             tag="instrumented") as sess:
        with torch.no_grad():
            logits, _, _ = model.forward(params, toks)
        counts = dict(sess.backend_instance().counts)
    if counts.get("dot_general", 0) <= 10 or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"swap 1: counting backend saw {counts}")
    log(f"[swap 1] counting backend under the full-width 2-layer "
        f"{cfg.name} forward saw {counts}")
    del model, params, logits
    torch.cuda.empty_cache()

    before = mm.launches
    with repro_torch.session(backend=HopperBackend()) as sess:
        a = torch.ones(128, 128, device="cuda")
        out = ops.matmul(a, a)
        torch.cuda.synchronize()
        calls = sess.backend_instance().kernel_calls
    if mm.launches != before + 1 or calls != 1 or float(out[0, 0]) != 128.0:
        raise AssertionError("swap 3: ops.matmul under hopper did not run "
                             "the kernel")
    log(f"[swap 3] hopper backend: {calls} kernel call(s), "
        f"result[0,0]={float(out[0, 0])}")

    seen = []

    def traced_matmul(lhs, rhs):
        seen.append((tuple(lhs.shape), tuple(rhs.shape)))
        return torch.matmul(lhs, rhs)

    with repro_torch.session(kernels={"matmul": traced_matmul}):
        a = torch.ones(32, 32, device="cuda")
        ops.matmul(a, a)
    if seen != [((32, 32), (32, 32))]:
        raise AssertionError(f"swap 4: the override saw {seen}")
    log(f"[swap 4] kernel override intercepted {len(seen)} matmul: {seen}")


def decode_ab(model, params, seed: int) -> None:
    """What the dispatch layer costs the host-bound decode step: the plain
    serve run again with the projections through ``ops.dot_general``
    (``models.layers.linear``) and through a direct ``torch.matmul`` (the
    projection before it went through the dispatch), in turns direct,
    dispatch, dispatch, direct; prints the decode ms per step of each."""
    from repro_torch.models import attention, layers

    dispatch = layers.linear

    def direct(x, w):
        return torch.matmul(x, w)

    ms = {"direct": [], "dispatch": []}
    try:
        for mode in ("direct", "dispatch", "dispatch", "direct"):
            layers.linear = attention.linear = (
                direct if mode == "direct" else dispatch)
            stats = {}
            serve(model, params, seed, speculative=False, stats=stats)
            ms[mode].append(stats["decode_ms"])
    finally:
        layers.linear = attention.linear = dispatch
    log("[decode-ab] decode ms per step at 8 slots, projections through "
        f"torch.matmul directly: {[round(x, 2) for x in ms['direct']]}; "
        f"through ops.dot_general: {[round(x, 2) for x in ms['dispatch']]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after the plain serve run, trace one admission "
                         "step (the prefill chunk calls) and this many "
                         "decode steps with torch.profiler and print where "
                         "the time goes; print the same breakdown of the "
                         "two profiled training steps and of the profiled "
                         "core steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    log(card_line())
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    build_kernels()
    rows = kernel_checks(args.seed) + training_kernel_checks(
        torch.Generator().manual_seed(args.seed + 5))
    rows.append(matmul_checks(torch.Generator().manual_seed(args.seed + 6)))
    model, params = full_width_model(args.seed)
    by_path = {"serve": serve(model, params, args.seed, speculative=False,
                              profile_steps=args.profile_steps),
               "speculative": serve(model, params, args.seed,
                                    speculative=True)}
    decode_ab(model, params, args.seed)
    del model, params
    torch.cuda.empty_cache()
    by_path["train"] = train_phase(args.seed, args.profile_steps)
    torch.cuda.empty_cache()
    logits_parity(args.seed)
    by_path["forward"] = train_parity(args.seed)
    torch.cuda.empty_cache()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    try:
        by_path["core"] = core_phase(args.seed, args.profile_steps)
        by_path["quickstart"] = quickstart_phase()
        swap_demo(args.seed)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']}: no launch on any path")
    token_identity(args.seed)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
