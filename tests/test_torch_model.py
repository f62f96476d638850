"""The port's model against the JAX ``LM`` on the same weights.

The reduced codeqwen1.5-7b config runs in float32 in both packages; the
reference's ``LM.init`` tree crosses as numpy through
``repro_torch.convert``.  Logits agree to 1e-4 absolute (float32; the
two frameworks sum in different orders and their cos/sin/pow differ by
an ulp), with values of order 0.1 to 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import build_model
from repro.models import layers as jlayers
from repro.serving.kv_cache import BlockTable as JBlockTable
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.models import layers as tlayers
from repro_torch.serving import BlockTable

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) on the CPU."""
    jm = build_model(jax_config("codeqwen1.5-7b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(get_config("codeqwen1.5-7b", reduced=True), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def test_port_config_matches_reference_fields():
    for reduced in (False, True):
        j = jax_config("codeqwen1.5-7b", reduced=reduced)
        t = get_config("codeqwen1.5-7b", reduced=reduced)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "rope_theta", "norm", "act",
                  "resolved_head_dim", "logit_softcap", "tie_embeddings"):
            assert getattr(j, f) == getattr(t, f), f
        assert str(j.param_dtype.dtype) == str(t.param_dtype).split(".")[1]


def test_param_tree_layout_matches_reference(pair):
    jm, jp, tm, tp = pair
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert jshapes == tshapes
    seeded = tm.init(0)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), seeded) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)


def test_forward_logits_match_reference(pair):
    jm, jp, tm, tp = pair
    tokens = np.random.default_rng(1).integers(0, 512, (2, 12))
    jl, _, _ = jm.forward(jp, jnp.asarray(tokens))
    tl, _, _ = tm.forward(tp, torch.from_numpy(tokens))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_unscanned_stages_convert_to_the_stacked_layout():
    jm = build_model(jax_config("codeqwen1.5-7b", reduced=True,
                                scan_layers=False))
    jp = jm.init(jax.random.PRNGKey(2))
    assert set(jp["stages"][0]) == {"r0", "r1", "r2"}
    tm = LM(get_config("codeqwen1.5-7b", reduced=True), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(2).integers(0, 512, (1, 7))
    jl, _, _ = jm.forward(jp, jnp.asarray(tokens))
    tl, _, _ = tm.forward(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_chunked_prefill_then_decode_match_reference(pair):
    """Two ragged prefill chunks at per-slot starts, then one decode step
    at per-slot positions, on a paged pool with scattered blocks and one
    idle slot: logits and every live pool row agree."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(4)
    slots, bs, mb, t = 4, 4, 6, 8
    num_blocks = slots * mb + 1
    table = np.zeros((slots, mb), np.int32)
    table[0, :5] = [7, 3, 12, 1, 20]
    table[1, :3] = [2, 9, 16]
    table[2, :6] = [4, 5, 6, 8, 10, 11]      # slot 3 stays idle
    prompt_len = np.array([14, 9, 21, 0])
    tokens = rng.integers(0, 512, (slots, 24))
    jcache = jm.init_paged_cache(slots, mb * bs, num_blocks=num_blocks,
                                 block_size=bs)
    tcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    jbt = JBlockTable(jnp.asarray(table), bs)
    tbt = BlockTable(torch.from_numpy(table), bs)
    for c in range(0, 24, t):
        count = np.clip(prompt_len - c, 0, t).astype(np.int32)
        start = np.full(slots, c, np.int32)
        chunk = tokens[:, c:c + t].astype(np.int32)
        jcache = jm.prefill_step(jp, jcache, jnp.asarray(chunk),
                                 jnp.asarray(start), jnp.asarray(count),
                                 block_table=jbt)
        tcache = tm.prefill_step(tp, tcache, torch.from_numpy(chunk),
                                 torch.from_numpy(start),
                                 torch.from_numpy(count), block_table=tbt)
    pos = prompt_len.astype(np.int32)
    tok = tokens[np.arange(slots), pos][:, None].astype(np.int32)
    jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                jnp.asarray(pos), block_table=jbt)
    tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                torch.from_numpy(pos), block_table=tbt)
    assert tl.shape == (slots, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **TOL)
    assert np.isfinite(tl.numpy()).all()
    live = np.concatenate([np.arange(blk * bs, blk * bs + bs)
                           for blk in table[table > 0]])
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[0][key].numpy()[:, live],
                                   np.asarray(jcache[0][key])[:, live],
                                   **TOL)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_and_rope_match_reference(act):
    cfg_j = jax_config("codeqwen1.5-7b", reduced=True, act=act)
    cfg_t = get_config("codeqwen1.5-7b", reduced=True, act=act)
    rng = np.random.default_rng(6)
    p = {k: rng.standard_normal(m.shape).astype(np.float32) * 0.2
         for k, m in jlayers.mlp_meta(cfg_j).items()}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), cfg_j)
    got = tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xr = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5))
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos),
                           1e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                                      1e6)), **TOL)
