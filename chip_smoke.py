#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases, each of which raises (non-zero exit) on failure:
  1. print the card's name and power limit; build both CUDA kernels from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the serving path gives it;
  3. time each kernel, its plain version and one PyTorch call for the
     same function (a yardstick the port never calls);
  4. serve codeqwen1.5-7b at full width (random weights from --seed,
     bf16) through ``ServeEngine`` on the paged cache: 8 requests with
     prompts of 128..1024 tokens and 64 new tokens each, counting every
     kernel launch of that run;
  5. hold the card's first decode logits of a 2-layer full-width model
     against the port on the CPU (plain versions, fp32 from the same
     bf16 weights).
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
# decode: the plain version rounds the softmax weights to bf16 before
#   the PV product (the reference's order), the kernel keeps them fp32;
#   outputs are averages of unit-scale values.
RMS_TOL = (1e-6, 2.0 ** -6)
DECODE_TOL = (1e-2, 2.0 ** -6)
# full-width 2-layer logits, card bf16 vs CPU fp32 on the same weights:
# logits have a spread of ~1.3; bf16 rounding through two layers and the
# bf16-rounded unembedding stays well inside 0.1.
LOGITS_ATOL = 0.1


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
    paths = build.build(["rmsnorm", "flash_decode"])
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
    for r in rows:
        log(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.5f} ms, "
            f"plain {r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} "
            f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


# -- phase 4 ------------------------------------------------------------------

def serve_full_width(seed: int, profile_steps: int = 0) -> dict[str, int]:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.runtime import ServingPolicy
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config("codeqwen1.5-7b")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"random bf16 weights from seed {seed} in "
        f"{time.perf_counter() - t0:.1f} s")
    policy = ServingPolicy(cache="paged", block_size=16, prefill_chunk=128)
    engine = ServeEngine(model, params, batch_slots=8, max_seq=2048,
                         policy=policy)

    prefill_s = [0.0]
    step = model.prefill_step

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*a, **kw)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return out

    model.prefill_step = timed_prefill
    rng = torch.Generator().manual_seed(seed + 1)
    # warm-up request: first cuBLAS calls and the kernels' first launches
    engine.submit(Request(uid=-1, prompt=torch.randint(
        cfg.vocab_size, (40,), generator=rng).tolist(), max_new_tokens=4))
    engine.run_until_done()
    prefill_s[0] = 0.0

    lens = [128 + (1024 - 128) * i // 7 for i in range(8)]
    reqs = [Request(uid=i, prompt=torch.randint(
        cfg.vocab_size, (n,), generator=rng).tolist(), max_new_tokens=64)
        for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    calls0 = (engine.prefill_calls, engine.decode_calls)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    if len(done) != len(reqs) or any(
            len(r.generated) != 64 or not all(0 <= t < cfg.vocab_size
                                              for t in r.generated)
            for r in done):
        raise AssertionError("serve: every request must finish with 64 "
                             "tokens in the vocabulary")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"serve: kernel {name} was never launched")
    n_prefill = engine.prefill_calls - calls0[0]
    n_decode = engine.decode_calls - calls0[1]
    n_prompt = sum(len(r.prompt) for r in reqs)
    n_gen = sum(len(r.generated) for r in reqs)
    decode_s = wall - prefill_s[0]
    ttft = sorted(r.first_token_time - r.submit_time for r in reqs)
    log(f"[serve] {len(done)} requests, {n_prompt} prompt tokens, {n_gen} "
        f"generated in {wall:.3f} s ({n_prefill} prefill chunk "
        f"calls, {n_decode} decode steps, "
        f"{engine.preemptions} preemptions)")
    log(f"[serve] prefill {n_prompt / prefill_s[0]:.1f} tokens/s "
        f"({prefill_s[0]:.3f} s); decode {n_gen / decode_s:.1f} tokens/s "
        f"({decode_s:.3f} s, {1e3 * decode_s / n_decode:.2f} "
        f"ms/step at 8 slots); TTFT p50 {ttft[len(ttft) // 2]:.3f} s")
    log(f"[serve] launches {counts}; per decode step: rms_norm "
        f"{2 * cfg.n_layers + 1}, paged_decode {cfg.n_layers}")
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile_steps:
        profile_decode(engine, reqs, profile_steps)
    del engine, params
    torch.cuda.empty_cache()
    return counts


def profile_decode(engine, reqs, steps: int) -> None:
    """Trace ``steps`` decode steps of a refilled engine with
    torch.profiler: device time by kernel and the device's busy share of
    the traced window (kernels run on one stream, so their times add)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    for r in reqs:
        engine.submit(Request(uid=100 + r.uid, prompt=r.prompt,
                              max_new_tokens=steps + 2))
    engine.step()                        # admission, prefill, first token
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.run_until_done()

    def dev_us(e):
        return (getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels)
    if not busy:
        log("[profile] the profiler reported no device time")
        return
    log(f"[profile] {steps} decode steps at 8 slots: {wall_us / steps:.0f} "
        f"us/step on the host clock, device busy {busy / steps:.0f} us/step "
        f"({100 * busy / wall_us:.1f} % of the window)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"[profile]   {dev_us(e) / steps:9.1f} us/step  "
            f"{e.count // steps:4d} launches/step  {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CPU]
    log(f"[profile] host ops by self time (profiler on, which adds its "
        f"own cost to each op):")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"[profile]   {e.self_cpu_time_total / steps:9.1f} us/step  "
            f"{e.count // steps:4d} calls/step  {e.key[:90]}")


# -- phase 5 ------------------------------------------------------------------

def logits_parity(seed: int) -> float:
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.meta import tree_map
    from repro_torch.serving import BlockTable

    cfg = get_config("codeqwen1.5-7b").with_(n_layers=2)
    gpu = LM(cfg)
    params = gpu.init(seed)
    prompt = torch.randint(cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(seed + 2))

    def first_logits(model, p):
        cache = model.init_paged_cache(1, 64, num_blocks=5, block_size=16)
        bt = BlockTable(torch.tensor([[1, 2, 3, 4]], dtype=torch.int32,
                                     device=model.device), 16)
        model.prefill_step(p, cache, prompt[:, :-1], [0], [39],
                           block_table=bt)
        logits, _ = model.decode_step(p, cache, prompt[:, -1:], [39],
                                      block_table=bt)
        return logits.float().cpu()

    card = first_logits(gpu, params)
    cpu_cfg = cfg.with_(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    cpu_params = tree_map(lambda t: t.float().cpu(), params)
    del params
    torch.cuda.empty_cache()
    ref = first_logits(LM(cpu_cfg, device="cpu"), cpu_params)
    err = float((card - ref).abs().max())
    same = int(card.argmax()) == int(ref.argmax())
    log(f"[parity] 2-layer full-width first decode logits: max abs err "
        f"{err:.4f} (limit {LOGITS_ATOL}), logit std {float(ref.std()):.3f}, "
        f"argmax {'agrees' if same else 'differs'}")
    if not bool(torch.isfinite(card).all()) or err > LOGITS_ATOL:
        raise AssertionError("parity: card logits disagree with the CPU")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after serving, trace this many decode steps "
                         "with torch.profiler and print where the time goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    log(card_line())
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    build_kernels()
    rows = kernel_checks(args.seed)
    counts = serve_full_width(args.seed, args.profile_steps)
    for r in rows:
        r["launches"] = counts[r["name"]]
    logits_parity(args.seed)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
