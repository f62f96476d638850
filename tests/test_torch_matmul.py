"""The matmul kernel's plain version against the reference kernel, the
wrapper's bookkeeping, and ``HopperBackend``'s dispatch.

* The plain version (``repro_torch.kernels.matmul.plain``) against the
  Pallas kernel run in interpret mode (``repro.kernels.matmul.matmul``)
  at tile-aligned shapes and against ``repro.kernels.ref.matmul`` at
  ragged ones: float32 to 1e-5 relative (fp32 sums in another order),
  bfloat16 to one bf16 ulp (both accumulate in fp32 and round once).
* The wrapper's card path (``kernels.ops.matmul``: 1-D operands, folded
  rows, broadcast and transposed batches, the three batch dimensions the
  kernel walks) with the launch replaced by a float64 product that reads
  A and B through exactly the strides and offsets the kernel would get,
  against ``torch.matmul``.
* ``HopperBackend``: every float matmul is a kernel call, integer ones
  fall back, CPU tensors take the plain version.

Inputs come from a seeded numpy generator.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels import matmul as jmm
from repro.kernels import ref as jref
from repro_torch.core.tensor import HopperBackend, ops
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops as kops

RTOL_F32 = 1e-5


def _inputs(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ta, tb, jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)


def _hold(got: torch.Tensor, want) -> None:
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    assert g.shape == w.shape
    if got.dtype == torch.float32:
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=RTOL_F32, atol=RTOL_F32 * scale)
    else:
        # one bf16 ulp at each value's magnitude (8 bits of mantissa)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), float(np.abs(g - w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mkn", [(128, 256, 128), (256, 128, 384)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret_at_aligned_shapes(mkn, dtype):
    ta, tb, ja, jb = _inputs(*mkn, dtype, seed=sum(mkn))
    want = jmm.matmul(ja, jb, bm=128, bn=128, bk=128, interpret=True)
    got = mm.plain(ta, tb)
    assert got.dtype == dtype
    _hold(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mkn", [(144, 64, 10), (64, 144, 64), (100, 30, 70),
                                 (33, 300, 17), (1, 7, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_ref_at_ragged_shapes(mkn, dtype):
    ta, tb, ja, jb = _inputs(*mkn, dtype, seed=sum(mkn) + 1)
    got = mm.plain(ta, tb)
    assert got.dtype == dtype
    _hold(got, jref.matmul(ja, jb))


def test_plain_promotes_mixed_dtypes():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    out = mm.plain(a, b.to(torch.bfloat16))
    assert out.dtype == torch.float32
    want = jnp.matmul(jnp.asarray(a.numpy()),
                      jnp.asarray(b.numpy()).astype(jnp.bfloat16))
    assert want.dtype == jnp.float32
    _hold(out, want)


# -- the wrapper's card path, its launch replaced by a float64 product ------

def _fake_launch(calls):
    def launch(a, a_strides, b, b_strides, c, m, n, k, batch):
        calls.append((tuple(batch), a_strides, b_strides))
        assert c.is_contiguous() and c.shape[-2:] == (m, n)
        c3 = c.view(-1, m, n)
        assert c3.shape[0] == math.prod(batch)
        for z in range(math.prod(batch)):
            idx, rest = [], z
            for size in reversed(batch):
                idx.append(rest % size)
                rest //= size
            idx.reverse()
            oa = a.storage_offset() + sum(i * s for i, s in
                                          zip(idx, a_strides[2:]))
            ob = b.storage_offset() + sum(i * s for i, s in
                                          zip(idx, b_strides[2:]))
            az = torch.as_strided(a, (m, k), a_strides[:2], oa)
            bz = torch.as_strided(b, (k, n), b_strides[:2], ob)
            c3[z] = (az.double() @ bz.double()).to(c.dtype)
    return launch


CASES = {
    "2d": lambda t: (t(5, 7), t(7, 3)),
    "linear_3d": lambda t: (t(2, 5, 7), t(7, 3)),
    "weight_grad_transposed": lambda t: (t(20, 7).t(), t(20, 3)),
    "grad_input_transposed_b": lambda t: (t(2, 5, 3), t(7, 3).t()),
    "batched_4d": lambda t: (t(2, 3, 5, 7), t(2, 3, 7, 4)),
    "scores_kT": lambda t: (t(2, 3, 5, 7), t(2, 3, 5, 7).transpose(-1, -2)),
    "broadcast_batch": lambda t: (t(2, 1, 5, 7), t(3, 7, 4)),
    "unfoldable_rows": lambda t: (t(5, 2, 7).transpose(0, 1), t(7, 3)),
    "four_batch_dims": lambda t: (t(2, 1, 3, 2, 5, 7)[:, :, :, :, ::2],
                                  t(2, 4, 1, 2, 7, 3)),
    "vec_mat": lambda t: (t(7), t(2, 7, 3)),
    "mat_vec": lambda t: (t(2, 5, 7), t(7)),
    "vec_vec": lambda t: (t(7), t(7)),
    "empty_k": lambda t: (t(4, 0), t(0, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_card_path_bookkeeping(case, monkeypatch):
    gen = torch.Generator().manual_seed(len(case))

    def t(*shape):
        return torch.randn(*shape, generator=gen)

    a, b = CASES[case](t)
    calls = []
    monkeypatch.setattr(kops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(mm, "launch", _fake_launch(calls))
    got = kops.matmul(a, b)
    want = torch.matmul(a.double(), b.double()).float()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    if got.numel():
        assert len(calls) == 1
        assert len(calls[0][0]) == mm.MAX_BATCH_DIMS
    if case in ("linear_3d", "grad_input_transposed_b"):
        assert calls[0][0] == (1, 1, 1)       # rows folded: one product
    if case == "weight_grad_transposed":
        assert calls[0][1][:2] == (1, 7)      # read through its strides


def test_wrapper_refuses_integer_operands_on_the_card(monkeypatch):
    monkeypatch.setattr(kops, "_on_cuda", lambda *ts: True)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        kops.matmul(torch.ones(2, 2, dtype=torch.int32),
                    torch.ones(2, 2, dtype=torch.int32))


def test_wrapper_refuses_torch_autograd_on_the_card(monkeypatch):
    """The kernel has no torch derivative: a traced operand (torch
    autograd, or ``torch.func`` inside the tape's ``lift``) raises."""
    monkeypatch.setattr(kops, "_on_cuda", lambda *ts: True)
    a = torch.ones(2, 2, requires_grad=True)
    with pytest.raises(ValueError, match="tape"):
        kops.matmul(a, torch.ones(2, 2))
    with pytest.raises(ValueError, match="tape"):
        torch.func.vjp(lambda x: kops.matmul(x, x), torch.ones(2, 2))


def test_wrapper_takes_plain_version_on_the_cpu():
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    before = mm.launches
    assert torch.equal(kops.matmul(a, b), mm.plain(a, b))
    assert mm.launches == before
    assert kops.KERNELS["matmul"] is mm


# -- HopperBackend -----------------------------------------------------------

@pytest.mark.parametrize("shapes", [((4, 5), (5, 3)), ((2, 4, 5), (5, 3)),
                                    ((2, 3, 4, 5), (2, 3, 5, 6)), ((5,), (5,)),
                                    ((144, 64), (64, 10))],
                         ids=lambda s: str(s))
def test_hopper_backend_runs_every_float_matmul_as_a_kernel(shapes):
    backend = HopperBackend()
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(*s, generator=gen) for s in shapes)
    with repro_torch.session(backend=backend):
        out = ops.matmul(a, b)
        out16 = ops.matmul(a.to(torch.bfloat16), b)
    assert backend.kernel_calls == 2 and backend.fallback_calls == 0
    assert out16.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), torch.matmul(a, b).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_hopper_backend_falls_back_on_integers():
    backend = HopperBackend()
    a = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    with repro_torch.session(backend=backend):
        out = ops.matmul(a, a.t())
    assert backend.fallback_calls == 1 and backend.kernel_calls == 0
    assert torch.equal(out, torch.matmul(a, a.t()))


def test_hopper_backend_rms_norm_hook_is_the_kernel_wrapper():
    from repro_torch.kernels import rmsnorm

    x = torch.randn(4, 8)
    w = torch.rand(8) + 0.5
    out = HopperBackend().rms_norm_fused(x, w)
    assert torch.equal(out, rmsnorm.plain(x, w))
