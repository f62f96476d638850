#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases, each of which raises (non-zero exit) on failure:
  1. print the card's name and power limit; build the three CUDA kernels
     from ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the serving path gives it (paged_verify at a
     prefill chunk, T=128, and at a speculative verify, T=5);
  3. time each kernel, its plain version and one PyTorch call for the
     same function (a yardstick the port never calls);
  4. serve codeqwen1.5-7b at full width (random weights from --seed,
     bf16) through ``ServeEngine`` on the paged cache: 8 requests with
     prompts of 128..1024 tokens and 64 new tokens each, counting every
     kernel launch of that run; then the same requests again with
     speculative decoding on (n-gram proposer, k=4), counting again;
  5. hold the card's first decode logits and verify logits of a 2-layer
     full-width model against the port on the CPU (plain versions, fp32
     from the same bf16 weights), and check that the speculative engine
     emits the plain engine's tokens on the card (2 layers, fp32).
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


def time_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so host overhead
    does not hide the device time of a small kernel."""
    fn()
    torch.cuda.synchronize()
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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
    paths = build.build(["rmsnorm", "flash_decode", "flash_verify"])
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
          profile_steps: int = 0) -> dict[str, int]:
    """One serve run of the 8 requests, plain or speculative (n-gram,
    k=4); returns the kernel launches of that run alone."""
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
    path = ("rms_norm", "paged_verify") if speculative else tuple(counts)
    for name in path:
        if counts[name] == 0:
            raise AssertionError(f"{tag}: kernel {name} was never launched")
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


def report_profile(prof, label: str, n: int, wall_us: float) -> None:
    from torch.autograd import DeviceType

    def dev_us(e):
        return (getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels)
    if not busy:
        log(f"[profile] {label}: the profiler reported no device time")
        return
    log(f"[profile] {label}: {wall_us / n:.0f} us/step on the host clock, "
        f"device busy {busy / n:.0f} us/step "
        f"({100 * busy / wall_us:.1f} % of the window)")
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


def token_identity(seed: int) -> None:
    """Plain and speculative engines on a 2-layer full-width fp32 model
    on the card emit the same tokens, but where the plain run's top two
    logits are within MARGIN_BOUND."""
    from repro_torch.models import LM
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
    diverged = 0
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
        logits, _, _ = model.forward(params,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after the plain serve run, trace one admission "
                         "step (the prefill chunk calls) and this many "
                         "decode steps with torch.profiler and print where "
                         "the time goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    log(card_line())
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    build_kernels()
    rows = kernel_checks(args.seed)
    model, params = full_width_model(args.seed)
    by_path = {"serve": serve(model, params, args.seed, speculative=False,
                              profile_steps=args.profile_steps),
               "speculative": serve(model, params, args.seed,
                                    speculative=True)}
    del model, params
    torch.cuda.empty_cache()
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    logits_parity(args.seed)
    token_identity(args.seed)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
