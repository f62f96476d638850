"""The port's training kernels on the CPU: the plain flash-attention
forward against the reference's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it), its plain backward against ``jax.vjp``
of the oracle ``repro.kernels.ref.flash_attention`` (the Pallas kernel
has no VJP), the RMSNorm backward against ``jax.vjp`` of the reference's
``apply_norm``, and float64 gradient checks of both autograd Functions.

Inputs are made with numpy from fixed seeds and handed to both packages
in float32.  Tolerances: forward outputs to 2e-5 (the online softmax of
the Pallas kernel sums in another order than the plain global softmax);
gradients to 1e-4 absolute and relative (they sum over up to S rows or
keys, in other orders, and dS subtracts Di = rowsum(dO * O) from dP,
which cancels); bfloat16 RMSNorm gradients to two bf16 ulps.
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ops as K
from repro.kernels import ref as R
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, rmsnorm

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# (S, H, Kv, D, causal, window, softcap): causal, sliding window, tanh
# softcap, GQA (H=4 over Kv=2), and a non-causal window
CASES = [(64, 2, 2, 32, True, 0, 0.0),
         (96, 4, 2, 16, True, 0, 0.0),
         (128, 4, 2, 32, True, 40, 0.0),
         (64, 4, 2, 32, True, 0, 20.0),
         (64, 4, 1, 16, True, 24, 5.0),
         (64, 2, 2, 16, False, 0, 0.0),
         (96, 4, 2, 16, False, 30, 0.0)]


def _inputs(seed, s, h, kvh, d, b=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                               (b, s, h, d)))


def _jax_oracle(q, k, v, *, causal, window, softcap):
    """The oracle in the model layout, kv heads repeated as the
    reference's ``ops.flash_attention`` does."""
    rep = q.shape[2] // k.shape[2]
    kt = jnp.repeat(k, rep, axis=2).transpose(0, 2, 1, 3)
    vt = jnp.repeat(v, rep, axis=2).transpose(0, 2, 1, 3)
    out = R.flash_attention(q.transpose(0, 2, 1, 3), kt, vt, causal=causal,
                            window=window, softcap=softcap)
    return out.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("s,h,kvh,d,causal,window,cap", CASES)
def test_plain_forward_matches_pallas_interpret(s, h, kvh, d, causal,
                                                window, cap):
    q, k, v, _ = _inputs(1, s, h, kvh, d)
    want = K.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, softcap=cap,
                             bq=32, bk=32)
    got, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    # lse is the log of the softmax normaliser of the capped scores
    scores = np.einsum("bqkgd,bskd->bkgqs",
                       q.reshape(2, s, kvh, h // kvh, d), k) / math.sqrt(d)
    if cap > 0:
        scores = np.tanh(scores / cap) * cap
    mask = fa.attention_mask(s, causal=causal, window=window).numpy()
    scores = np.where(mask, scores, -np.inf)
    want_lse = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) \
        + scores.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(2, h, s),
                               **FWD_TOL)


@pytest.mark.parametrize("s,h,kvh,d,causal,window,cap", CASES)
def test_plain_backward_matches_jax_vjp_of_the_oracle(s, h, kvh, d, causal,
                                                      window, cap):
    q, k, v, do = _inputs(2, s, h, kvh, d)
    kw = dict(causal=causal, window=window)
    want_o, vjp = jax.vjp(
        lambda q, k, v: _jax_oracle(q, k, v, softcap=cap, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, cap=cap, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **FWD_TOL)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse,
                                       torch.from_numpy(do), cap=cap, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 3, 3.0),
                                               (False, 3, 0.0)])
def test_flash_attention_function_passes_gradcheck(causal, window, cap):
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(1, 7, 2, 4, generator=gen, dtype=torch.float64)
    k = torch.randn(1, 7, 1, 4, generator=gen, dtype=torch.float64)
    v = torch.randn(1, 7, 1, 4, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal,
                                            window=window, softcap=cap),
        tuple(t.requires_grad_() for t in (q, k, v)))


def test_rms_norm_function_passes_gradcheck():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 5, 16, generator=gen, dtype=torch.float64)
    w = torch.randn(16, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x, w: ops.rms_norm_fn(x, w),
        (x.requires_grad_(), w.requires_grad_()))


@pytest.mark.parametrize("shape", [(8, 64), (2, 7, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_bwd_plain_matches_jax_vjp_of_apply_norm(shape, dtype):
    rng = np.random.default_rng(5)
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    cfg = jax_config("codeqwen1.5-7b", reduced=True)
    _, vjp = jax.vjp(lambda x, w: jlayers.apply_norm({"scale": w}, x, cfg),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_dx, want_dw = vjp(jnp.asarray(dy, jdt))
    dx, dw = ops.rms_norm_bwd(*(torch.from_numpy(a).to(tdt)
                                for a in (x, w, dy)))
    assert dx.dtype == tdt and dw.dtype == tdt
    tol = (dict(rtol=2.0 ** -7, atol=2.0 ** -7) if dtype == "bf16"
           else dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32), **tol)
    # dw sums over every row; in bf16 the last bits of a sum of up to 14
    # terms may round either way
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(want_dw, np.float32),
                               **(dict(rtol=2.0 ** -6, atol=2.0 ** -6)
                                  if dtype == "bf16" else tol))


def test_cpu_training_ops_take_the_plain_versions_without_a_launch():
    before = ops.launch_counts()
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    x = torch.randn(4, 16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    (ops.flash_attention(q, q, q).sum()
     + ops.rms_norm_fn(x, w).sum()).backward()
    assert ops.launch_counts() == before
    assert {"flash_attention", "flash_attention_bwd", "rms_norm_bwd"} \
        <= set(before)


def test_training_kernels_name_their_sources_and_tpu_kernels():
    root = pathlib.Path(__file__).resolve().parents[1]
    for kernel in (fa, fa.bwd, rmsnorm.bwd):
        assert (root / kernel.SOURCE).is_file()
        path, line = kernel.REPLACES.split(":")
        src = (root / path).read_text().splitlines()
        assert src[int(line) - 1].startswith("def ")
    assert "def flash_attention(" in (root / "src/repro/kernels/"
                                      "flash_attention.py").read_text() \
        .splitlines()[int(fa.REPLACES.split(":")[1]) - 1]
