"""The port's kernel modules on the CPU: each plain version against the
reference's Pallas kernel (interpret mode, as tests/test_kernels.py runs
it), its oracle in ``repro.kernels.ref``, and the jnp path the serving
decode actually runs (``_paged_gather`` + ``plain_cache_attention``).

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: float32 results agree to 2e-5 (summation order only);
bfloat16 results to one or two bf16 ulps (rtol 2e-2, as in
tests/test_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro.kernels import ref as R
from repro.models import attention as jattn
from repro.serving.kv_cache import BlockTable as JBlockTable
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, rmsnorm

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a jnp array and a torch tensor."""
    t = torch.from_numpy(a.copy())
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), t.to(torch.bfloat16)
    return jnp.asarray(a), t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(8, 128), (4, 16, 256), (2, 3, 5, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(11)
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    got = ops.rms_norm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(K.rms_norm(xj, wj)), **tol)
    np.testing.assert_allclose(_np(got), _np(R.rms_norm(xj, wj)), **tol)


@pytest.mark.parametrize("per_row", [False, True])
def test_flash_decode_contiguous_matches_pallas_and_ref(per_row):
    rng = np.random.default_rng(3)
    n, s, d = 4, 256, 64
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((n, d), (n, s, d), (n, s, d)))
    if per_row:
        valid = rng.random((n, s)) < 0.6
        valid[2] = False                  # a row with no valid position
    else:
        valid = np.arange(s) < 173
    args_j = [jnp.asarray(a) for a in (q, k, v, valid)]
    got = ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    np.testing.assert_allclose(_np(got), _np(K.flash_decode(*args_j, bk=64)),
                               **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(R.flash_decode(*args_j)),
                               **F32_TOL)
    if per_row:
        assert not got[2].any()           # masked row: zeros, not NaN


def _paged_case(rng, *, b, h, kvh, d, bs, mb, lengths):
    """A pool with each row's blocks scattered over it, unmapped entries
    on the trash block 0; row i attends positions < lengths[i]."""
    num_blocks = b * mb + 1
    table = np.zeros((b, mb), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    used = 0
    for i, n in enumerate(lengths):
        if n is None:                     # inactive row: table of zeros
            continue
        nb = -(-n // bs)
        table[i, :nb] = perm[used:used + nb]
        used += nb
    lens = np.array([1 if n is None else n for n in lengths], np.int32)
    pool = num_blocks * bs
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((pool, kvh, d)).astype(np.float32)
    v = rng.standard_normal((pool, kvh, d)).astype(np.float32)
    return q, k, v, table, lens


@pytest.mark.parametrize("h,kvh,cap", [(4, 4, 0.0), (8, 2, 0.0),
                                       (8, 2, 5.0)])
def test_paged_decode_matches_gathered_plain_cache_attention(h, kvh, cap):
    rng = np.random.default_rng(h * 10 + kvh)
    bs, mb, d = 8, 6, 32
    q, k, v, table, lens = _paged_case(
        rng, b=5, h=h, kvh=kvh, d=d, bs=bs, mb=mb,
        lengths=[48, 1, 17, None, 40])
    scale = 1 / np.sqrt(d)
    bt = JBlockTable(jnp.asarray(table), bs)
    kview, vview = jattn._paged_gather({"k": jnp.asarray(k),
                                        "v": jnp.asarray(v)}, bt,
                                       jnp.float32)
    valid = jattn.decode_valid_mask(jnp.asarray(lens - 1), mb * bs)
    want = jattn.plain_cache_attention(jnp.asarray(q), kview, vview, valid,
                                       scale=scale, cap=cap)
    got = ops.paged_decode(*(torch.from_numpy(a) for a in
                             (q, k, v, table, lens)),
                           block_size=bs, scale=scale, cap=cap)
    assert got.shape == (5, h, d)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert np.isfinite(_np(got)).all()


def test_paged_decode_one_head_equals_reference_flash_decode():
    """Per query head, paged decode is the reference ``flash_decode``
    oracle over that head's gathered rows."""
    rng = np.random.default_rng(5)
    bs, mb, d = 4, 8, 64
    q, k, v, table, lens = _paged_case(rng, b=3, h=2, kvh=2, d=d, bs=bs,
                                       mb=mb, lengths=[32, 9, 3])
    got = ops.paged_decode(*(torch.from_numpy(a) for a in
                             (q, k, v, table, lens)),
                           block_size=bs, scale=1 / np.sqrt(d))
    idx = np.asarray(jattn._paged_read_index(
        JBlockTable(jnp.asarray(table), bs)))
    valid = np.arange(mb * bs)[None, :] < lens[:, None]
    for head in range(2):
        want = R.flash_decode(jnp.asarray(q[:, head]),
                              jnp.asarray(k[idx, head]),
                              jnp.asarray(v[idx, head]), jnp.asarray(valid))
        np.testing.assert_allclose(_np(got[:, head]), _np(want), **F32_TOL)


def test_paged_plain_in_bf16_matches_reference_rounding():
    """In bf16 the plain version rounds where the reference does (the
    softmax weights before the PV product, the output)."""
    rng = np.random.default_rng(9)
    bs, mb, d = 8, 4, 32
    q, k, v, table, lens = _paged_case(rng, b=2, h=2, kvh=2, d=d, bs=bs,
                                       mb=mb, lengths=[30, 7])
    bt = JBlockTable(jnp.asarray(table), bs)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kview, vview = jattn._paged_gather({"k": kj, "v": vj}, bt, jnp.bfloat16)
    valid = jattn.decode_valid_mask(jnp.asarray(lens - 1), mb * bs)
    want = jattn.plain_cache_attention(qj, kview, vview, valid,
                                       scale=1 / np.sqrt(d))
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.paged_decode(qt, kt, vt, torch.from_numpy(table),
                           torch.from_numpy(lens), block_size=bs,
                           scale=1 / np.sqrt(d))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = ops.launch_counts()
    x = torch.ones(2, 16)
    np.testing.assert_allclose(ops.rms_norm(x, torch.ones(16)).numpy(),
                               rmsnorm.plain(x, torch.ones(16)).numpy())
    q = torch.zeros(1, 2, 32)
    pool = torch.zeros(8, 2, 32)
    ops.paged_decode(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32), block_size=4,
                     scale=1.0)
    assert ops.launch_counts() == before
    assert set(before) == set(ops.KERNELS)


def test_wrappers_refuse_devices_they_cannot_serve():
    meta = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rms_norm(meta, torch.empty(16, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        ops.rms_norm(torch.ones(2, 16), torch.empty(16, device="meta"))


def test_kernel_modules_name_their_sources_and_tpu_kernels():
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    for mod in (rmsnorm, fd):
        assert (root / mod.SOURCE).is_file()
        path, line = mod.REPLACES.split(":")
        src = (root / path).read_text().splitlines()
        assert src[int(line) - 1].startswith("def ")
