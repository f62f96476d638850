"""The port's flash-verify path on the CPU: the plain versions against
the reference's Pallas ``flash_verify`` (interpret mode, as
tests/test_kernels.py runs it) and its oracle ``ref.flash_verify``, the
paged plain version against the contiguous one, and the model functions
that run it (``gqa_prefill_chunk``, ``LM.verify_step``) against the JAX
ones on the same weights.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: float32 kernels agree to 2e-5 (summation order only) and the
model to 1e-4 (as tests/test_torch_model.py: cos/sin/pow differ by an
ulp between the frameworks); bfloat16 results to one or two bf16 ulps
(rtol 2e-2, as in tests/test_kernels.py).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ops as K
from repro.kernels import ref as R
from repro.models import attention as jattn
from repro.models import build_model
from repro.serving.kv_cache import BlockTable as JBlockTable
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_verify as fv
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.serving import BlockTable

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _staircase(n, s, t, starts) -> np.ndarray:
    """Row i, query j sees positions <= starts[i] + j (the reference
    sweep's verify-span mask)."""
    starts = np.asarray(starts)
    return (np.arange(s)[None, None, :]
            <= starts[:, None, None] + np.arange(t)[None, :, None])


@pytest.mark.parametrize("s,t,d,bk", [(256, 5, 64, 64), (512, 3, 128, 128),
                                      (128, 1, 32, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_verify_matches_pallas_and_ref(s, t, d, bk, dtype):
    n = 4
    rng = np.random.default_rng(s + t + d)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((n, t, d), (n, s, d), (n, s, d)))
    valid = _staircase(n, s, t, [1, 40, 100, s - t])
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    qj, kj, vj = (jnp.asarray(a, jdt) for a in (q, k, v))
    got = ops.flash_verify(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(valid))
    assert got.dtype == tdt and got.shape == (n, t, d)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    np.testing.assert_allclose(
        _np(got), _np(K.flash_verify(qj, kj, vj, jnp.asarray(valid), bk=bk,
                                     interpret=True)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(R.flash_verify(qj, kj, vj, jnp.asarray(valid))), **tol)


def test_flash_verify_t1_equals_flash_decode():
    """flash_decode is the T=1 case of flash_verify, in the port too."""
    rng = np.random.default_rng(7)
    n, s, d = 5, 256, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((n, d), (n, s, d), (n, s, d)))
    valid = torch.arange(s)[None, :] < torch.tensor([1, 64, 100, 200, 256])[
        :, None]
    wide = ops.flash_verify(q[:, None], k, v, valid[:, None])
    narrow = ops.flash_decode(q, k, v, valid)
    np.testing.assert_allclose(_np(wide[:, 0]), _np(narrow), rtol=1e-5,
                               atol=1e-6)


def _scattered(rng, *, b, bs, mb, spans):
    """A table with each row's blocks scattered over the pool; a row
    mapped up to ``spans[i]`` positions (0 = unmapped: zeros)."""
    num_blocks = b * mb + 1
    table = np.zeros((b, mb), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    used = 0
    for i, n in enumerate(spans):
        nb = -(-n // bs)
        table[i, :nb] = perm[used:used + nb]
        used += nb
    return table, num_blocks * bs


@pytest.mark.parametrize("h,kvh,cap", [(4, 4, 0.0), (4, 2, 0.0),
                                       (4, 2, 5.0)])
def test_paged_plain_equals_contiguous_on_a_scattered_table(h, kvh, cap):
    """Ragged starts, a count-0 row, padding rows and GQA 4-over-2: per
    query head, the paged version is the contiguous one over that head's
    kv rows, gathered here by hand from the table."""
    rng = np.random.default_rng(h * 10 + kvh + int(cap))
    b, t, d, bs, mb = 5, 6, 32, 4, 12
    start = np.array([0, 17, 30, 0, 41], np.int32)
    count = np.array([6, 3, 6, 0, 1], np.int32)
    table, pool = _scattered(rng, b=b, bs=bs, mb=mb,
                             spans=start + count)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((pool, kvh, d)).astype(np.float32)
    v = rng.standard_normal((pool, kvh, d)).astype(np.float32)
    scale = 1 / np.sqrt(d)
    got = ops.paged_verify(*(torch.from_numpy(a) for a in
                             (q, k, v, table, start, count)),
                           block_size=bs, scale=scale, cap=cap)
    assert got.shape == (b, t, h, d)
    rows = np.array([[table[i, p // bs] * bs + p % bs for p in range(mb * bs)]
                     for i in range(b)])
    valid = (_staircase(b, mb * bs, t, start)
             & (np.arange(t)[None, :] < count[:, None])[..., None])
    for head in range(h):
        kh = torch.from_numpy(k[rows, head // (h // kvh)])
        vh = torch.from_numpy(v[rows, head // (h // kvh)])
        want = fv.contiguous_plain(torch.from_numpy(q[:, :, head]), kh, vh,
                                   torch.from_numpy(valid), scale=scale,
                                   cap=cap)
        np.testing.assert_allclose(_np(got[:, :, head]), _np(want),
                                   **F32_TOL)
        if cap == 0.0:
            ref = R.flash_verify(jnp.asarray(q[:, :, head]),
                                 jnp.asarray(kh.numpy()),
                                 jnp.asarray(vh.numpy()), jnp.asarray(valid),
                                 scale=scale)
            np.testing.assert_allclose(_np(got[:, :, head]), _np(ref),
                                       **F32_TOL)
    padding = np.arange(t)[None, :] >= count[:, None]
    assert not got.numpy()[padding].any()     # padding and idle rows: 0


def test_paged_plain_bf16_rounds_where_the_reference_does():
    """In bf16 the paged version rounds the softmax weights to bf16
    before the PV product, as ``_sdpa_ref`` over the gathered view."""
    rng = np.random.default_rng(21)
    b, t, h, d, bs, mb = 3, 4, 2, 32, 8, 4
    start = np.array([0, 9, 20], np.int32)
    count = np.array([4, 4, 2], np.int32)
    table, pool = _scattered(rng, b=b, bs=bs, mb=mb, spans=start + count)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((pool, h, d)).astype(np.float32)
    v = rng.standard_normal((pool, h, d)).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kview, vview = jattn._paged_gather(
        {"k": kj, "v": vj}, JBlockTable(jnp.asarray(table), bs), jnp.bfloat16)
    pos = jnp.asarray(start[:, None] + np.arange(t)[None, :])
    mask = jnp.arange(mb * bs)[None, None, :] <= pos[..., None]
    want = jattn._sdpa_ref(qj, kview, vview, mask, 1 / np.sqrt(d))
    got = ops.paged_verify(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        *(torch.from_numpy(a) for a in (table, start, count)),
        block_size=bs, scale=1 / np.sqrt(d))
    assert got.dtype == torch.bfloat16
    live = np.arange(t)[None, :] < count[:, None]
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], **BF16_TOL)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_gqa_prefill_chunk_matches_reference(kv_heads):
    """One layer's chunk over a pool that already holds earlier chunks:
    the outputs of every real token and every live pool row agree."""
    cfg_j = jax_config("codeqwen1.5-7b", reduced=True, n_kv_heads=kv_heads)
    cfg_t = get_config("codeqwen1.5-7b", reduced=True, n_kv_heads=kv_heads)
    rng = np.random.default_rng(30 + kv_heads)
    b, t, bs, mb = 4, 8, 4, 8
    start = np.array([0, 8, 21, 0], np.int32)
    count = np.array([8, 5, 8, 0], np.int32)
    table, pool = _scattered(rng, b=b, bs=bs, mb=mb, spans=start + count)
    hd = cfg_t.resolved_head_dim
    p = {k: (rng.standard_normal(m.shape) * 0.2).astype(np.float32)
         for k, m in jattn.gqa_meta(cfg_j).items()}
    cache = {k: rng.standard_normal((pool, kv_heads, hd)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((b, t, cfg_t.d_model)).astype(np.float32)
    positions = (start[:, None] + np.arange(t)[None, :]).astype(np.int32)
    want, jcache = jattn.gqa_prefill_chunk(
        {k: jnp.asarray(a) for k, a in p.items()},
        {k: jnp.asarray(a) for k, a in cache.items()}, jnp.asarray(x), cfg_j,
        positions=jnp.asarray(positions), count=jnp.asarray(count),
        block_table=JBlockTable(jnp.asarray(table), bs))
    tcache = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    got, tcache = tattn.gqa_prefill_chunk(
        {k: torch.from_numpy(a) for k, a in p.items()}, tcache,
        torch.from_numpy(x), cfg_t, positions=torch.from_numpy(positions),
        count=torch.from_numpy(count),
        block_table=BlockTable(torch.from_numpy(table), bs))
    live = np.arange(t)[None, :] < count[:, None]
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], **MODEL_TOL)
    rows = np.concatenate([np.arange(blk * bs, blk * bs + bs)
                           for blk in table[table > 0]])
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy()[rows],
                                   np.asarray(jcache[key])[rows], **MODEL_TOL)


@pytest.fixture(scope="module")
def pair():
    jm = build_model(jax_config("codeqwen1.5-7b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(3))
    tm = LM(get_config("codeqwen1.5-7b", reduced=True), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def test_verify_step_matches_reference(pair):
    """Prefill ragged prompts, then one wide verify of per-slot spans
    (count 0 for an idle slot, 1..5 for the rest): the [B, T, V] logits
    of every real position agree, and every verify logit row equals the
    decode step's at the same token and position."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(8)
    slots, bs, mb, t = 4, 4, 8, 5
    prompt_len = np.array([11, 6, 0, 17])
    table, pool = _scattered(rng, b=slots, bs=bs, mb=mb,
                             spans=np.full(slots, mb * bs))
    tokens = rng.integers(0, 512, (slots, 32)).astype(np.int32)
    jcache = jm.init_paged_cache(slots, mb * bs, num_blocks=pool // bs,
                                 block_size=bs)
    tcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    jbt = JBlockTable(jnp.asarray(table), bs)
    tbt = BlockTable(torch.from_numpy(table), bs)
    start = np.zeros(slots, np.int32)
    count = prompt_len.astype(np.int32)
    chunk = tokens[:, :17]
    jcache = jm.prefill_step(jp, jcache, jnp.asarray(chunk), start, count,
                             block_table=jbt)
    tcache = tm.prefill_step(tp, tcache, torch.from_numpy(chunk),
                             torch.from_numpy(start),
                             torch.from_numpy(count), block_table=tbt)
    vstart = prompt_len.astype(np.int32)
    vcount = np.array([5, 1, 0, 3], np.int32)
    span = np.stack([tokens[i, vstart[i]:vstart[i] + t]
                     for i in range(slots)]).astype(np.int32)
    jl, _ = jm.verify_step(jp, jcache, jnp.asarray(span), vstart, vcount,
                           block_table=jbt)
    tl, _ = tm.verify_step(tp, tcache, torch.from_numpy(span),
                           torch.from_numpy(vstart),
                           torch.from_numpy(vcount), block_table=tbt)
    assert tl.shape == (slots, t, 512) and tl.dtype == torch.float32
    assert np.isfinite(tl.numpy()).all()
    live = np.arange(t)[None, :] < vcount[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               **MODEL_TOL)
    # position 0 of each span is what a decode step at vstart computes
    dl, _ = tm.decode_step(tp, tcache, torch.from_numpy(span[:, :1]),
                           torch.from_numpy(vstart), block_table=tbt)
    np.testing.assert_allclose(dl.numpy()[vcount > 0],
                               tl.numpy()[vcount > 0, 0], **MODEL_TOL)


def test_cpu_tensors_take_the_verify_plain_version_without_a_launch():
    before = ops.launch_counts()
    q = torch.zeros(1, 3, 2, 32)
    pool = torch.zeros(8, 2, 32)
    one = torch.ones(1, dtype=torch.int32)
    out = ops.paged_verify(q, pool, pool,
                           torch.zeros(1, 2, dtype=torch.int32), one, one,
                           block_size=4, scale=1.0)
    assert out.shape == q.shape
    ops.flash_verify(torch.zeros(2, 3, 32), torch.zeros(2, 8, 32),
                     torch.zeros(2, 8, 32), torch.ones(2, 3, 8, dtype=bool))
    assert ops.launch_counts() == before
    assert "paged_verify" in before


def test_verify_module_names_its_source_and_tpu_kernel():
    root = pathlib.Path(__file__).resolve().parents[1]
    assert (root / fv.SOURCE).is_file()
    path, line = fv.REPLACES.split(":")
    src = (root / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def flash_verify(")
