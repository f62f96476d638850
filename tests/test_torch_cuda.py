"""The port's kernels on the card, against their plain versions.

These tests need an NVIDIA card (sm_90a) and nvcc; elsewhere they skip.
Run them on the card with:  python -m pytest -m gpu tests/test_torch_cuda.py
Tolerances as in chip_smoke.py: bf16 within 2 ulps (rtol 2^-6) plus a
small atol for the attention kernels' fp32-vs-bf16 softmax weights; fp32
to 1e-5; flash attention (bf16 only) also by relative L2 error, per
tensor and per row (see REL_TOL below).
"""

import math

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_verify as fv
from repro_torch.kernels import ops, rmsnorm

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -6),
       torch.float32: dict(atol=1e-5, rtol=1e-5)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("shape", [(8, 4096), (1024, 4096), (3, 5, 64)])
@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32),
                                          (torch.float32, torch.float32)])
def test_rms_norm_kernel_matches_plain(gen, shape, dtype, wdtype):
    x = _randn(gen, *shape, dtype=dtype)
    w = _randn(gen, shape[-1], dtype=wdtype)
    before = rmsnorm.launches
    got = ops.rms_norm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(got, rmsnorm.plain(x, w), **TOL[dtype])


@pytest.mark.parametrize("h,kvh,d,cap", [(32, 32, 128, 0.0),
                                         (32, 8, 128, 30.0),
                                         (8, 2, 64, 0.0), (4, 4, 256, 0.0),
                                         (4, 1, 32, 0.0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_matches_plain(gen, h, kvh, d, cap, dtype):
    b, bs, mb = 5, 16, 12
    num_blocks = b * mb + 1
    lengths = torch.tensor([192, 1, 77, 1, 16], dtype=torch.int32,
                           device="cuda")
    table = torch.zeros(b, mb, dtype=torch.int32, device="cuda")
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    used = 0
    for i in (0, 2, 4):                      # rows 1 and 3 stay inactive
        n = -(-int(lengths[i]) // bs)
        table[i, :n] = perm[used:used + n].int()
        used += n
    q = _randn(gen, b, h, d, dtype=dtype)
    k = _randn(gen, num_blocks * bs, kvh, d, dtype=dtype)
    v = _randn(gen, num_blocks * bs, kvh, d, dtype=dtype)
    kw = dict(block_size=bs, scale=1 / math.sqrt(d), cap=cap)
    got = ops.paged_decode(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, fd.paged_plain(q, k, v, table, lengths, **kw), **TOL[dtype])


def test_flash_decode_contiguous_entry_matches_plain(gen):
    q = _randn(gen, 6, 128, dtype=torch.bfloat16)
    k = _randn(gen, 6, 320, 128, dtype=torch.bfloat16)
    v = _randn(gen, 6, 320, 128, dtype=torch.bfloat16)
    valid = torch.rand(6, 320, generator=gen, device="cuda") < 0.3
    valid[1] = False
    got = ops.flash_decode(q, k, v, valid)
    torch.testing.assert_close(got, fd.contiguous_plain(q, k, v, valid),
                               **TOL[torch.bfloat16])
    assert not got[1].any()
    shared = torch.arange(320, device="cuda") < 100
    torch.testing.assert_close(ops.flash_decode(q, k, v, shared),
                               fd.contiguous_plain(q, k, v, shared),
                               **TOL[torch.bfloat16])


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 8, 4096, dtype=torch.bfloat16)
    w = _randn(gen, 4096, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rms_norm(x.t(), _randn(gen, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        ops.rms_norm(x.half(), w)
    with pytest.raises(ValueError, match="several devices"):
        ops.rms_norm(x, w.cpu())
    q = _randn(gen, 2, 4, 48)
    pool = _randn(gen, 16, 4, 48)
    table = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    lengths = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode(q, pool, pool, table, lengths, block_size=8,
                         scale=1.0)
    q = _randn(gen, 2, 4, 64)
    pool = _randn(gen, 16, 4, 64)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode(q, pool, pool, table.long(), lengths, block_size=8,
                         scale=1.0)


def _verify_case(gen, *, t, h, kvh, d, dtype, bs=16, mb=24):
    """Ragged starts over a scattered table: full rows, a half row, an
    idle row (count 0, table of zeros) and a row whose padding runs past
    the table's last position."""
    length = mb * bs
    start = [0, 37, 150, 0, length - 2]
    count = [t, max(1, t // 2), t, 0, min(t, 2)]
    b = len(start)
    num_blocks = b * mb + 1
    table = torch.zeros(b, mb, dtype=torch.int32, device="cuda")
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    used = 0
    for i in range(b):
        n = -(-(start[i] + count[i]) // bs) if count[i] else 0
        table[i, :n] = perm[used:used + n].int()
        used += n
    q = _randn(gen, b, t, h, d, dtype=dtype)
    k = _randn(gen, num_blocks * bs, kvh, d, dtype=dtype)
    v = _randn(gen, num_blocks * bs, kvh, d, dtype=dtype)
    ints = dict(dtype=torch.int32, device="cuda")
    return (q, k, v, table, torch.tensor(start, **ints),
            torch.tensor(count, **ints), bs)


@pytest.mark.parametrize("h,kvh,d,cap", [(32, 32, 128, 0.0),
                                         (32, 8, 128, 30.0),
                                         (8, 2, 64, 0.0), (4, 4, 256, 0.0),
                                         (4, 1, 32, 5.0)])
@pytest.mark.parametrize("t", [1, 5, 16, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_verify_kernel_matches_plain(gen, h, kvh, d, cap, t, dtype):
    q, k, v, table, start, count, bs = _verify_case(
        gen, t=t, h=h, kvh=kvh, d=d, dtype=dtype)
    kw = dict(block_size=bs, scale=1 / math.sqrt(d), cap=cap)
    before = fv.launches
    got = ops.paged_verify(q, k, v, table, start, count, **kw)
    torch.cuda.synchronize()
    assert fv.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, fv.paged_plain(q, k, v, table, start, count, **kw),
        **TOL[dtype])
    padding = (torch.arange(t, device="cuda")[None, :]
               >= count[:, None])
    assert not got[padding].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_verify_t1_equals_paged_decode(gen, dtype):
    q, k, v, table, start, count, bs = _verify_case(
        gen, t=1, h=32, kvh=8, d=128, dtype=dtype)
    count = torch.ones_like(count)
    kw = dict(block_size=bs, scale=1 / math.sqrt(128))
    wide = ops.paged_verify(q, k, v, table, start, count, **kw)
    narrow = ops.paged_decode(q[:, 0].contiguous(), k, v, table, start + 1,
                              **kw)
    torch.testing.assert_close(wide[:, 0], narrow, **TOL[dtype])


def test_flash_verify_contiguous_entry_matches_plain(gen):
    n, t, s, d = 4, 5, 512, 128
    q = _randn(gen, n, t, d, dtype=torch.bfloat16)
    k = _randn(gen, n, s, d, dtype=torch.bfloat16)
    v = _randn(gen, n, s, d, dtype=torch.bfloat16)
    starts = torch.tensor([1, 40, 100, s - t], device="cuda")
    valid = (torch.arange(s, device="cuda")[None, None, :]
             <= starts[:, None, None]
             + torch.arange(t, device="cuda")[None, :, None])
    valid[2, 3] = False                      # a row with no valid key
    got = ops.flash_verify(q, k, v, valid)
    torch.testing.assert_close(got, fv.contiguous_plain(q, k, v, valid),
                               **TOL[torch.bfloat16])
    assert not got[2, 3].any()


def test_verify_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    q, k, v, table, start, count, bs = _verify_case(
        gen, t=5, h=4, kvh=2, d=64, dtype=torch.bfloat16)
    kw = dict(block_size=bs, scale=1.0)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_verify(q, k, v, table, start.long(), count, **kw)
    with pytest.raises(ValueError, match="dtypes"):
        ops.paged_verify(q.float(), k, v, table, start, count, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_verify(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                         v, table, start, count, **kw)
    with pytest.raises(ValueError, match="several devices"):
        ops.paged_verify(q, k, v, table, start.cpu(), count, **kw)
    with pytest.raises(ValueError, match="heads over"):
        ops.paged_verify(q[:, :, :3].contiguous(), k, v, table, start, count,
                         **kw)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_verify(_randn(gen, 5, 5, 4, 48), _randn(gen, 16, 2, 48),
                         _randn(gen, 16, 2, 48), table, start, count, **kw)
    with pytest.raises(ValueError, match="valid"):
        ops.flash_verify(q[:, :, 0], k[:40].view(5, 8, 2, 64)[:, :, 0],
                         k[:40].view(5, 8, 2, 64)[:, :, 0],
                         torch.ones(5, 5, 7, dtype=torch.bool, device="cuda"))


# -- training kernels ---------------------------------------------------------
# Flash attention, bf16 only on the card: the plain versions round P (and
# dS) to bf16 before the products that take them, as the kernels do, so
# the two differ in summation order and where such a rounding flips.
# Outputs are ~0.03 at late rows and keys, so as in chip_smoke.py each of
# o, dq, dk, dv is held by its relative L2 error (1e-2) and each row (one
# position and head) by its L2 error over its norm plus 1 % of the median
# row norm (5e-2): an error confined to a few late tiles fails.
REL_TOL, ROW_TOL = 1e-2, 5e-2
# softcap 2 on ~N(0,1) scores: tanh far from linear (see _assert_cap_moves)
SOFTCAP = 2.0


def _rel_err(got, want):
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    diff = (got - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    return (float(diff.norm() / norm.norm()),
            float((diff / (norm + 0.01 * norm.median())).max()))


def _assert_rel_close(got, want, name):
    assert torch.isfinite(got).all(), name
    whole, row = _rel_err(got, want)
    assert whole <= REL_TOL and row <= ROW_TOL, (name, whole, row)


@pytest.mark.parametrize("shape", [(8, 4096), (300, 4096), (3, 5, 64)])
@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32),
                                          (torch.float32, torch.float32)])
def test_rms_norm_bwd_kernel_matches_plain(gen, shape, dtype, wdtype):
    x = _randn(gen, *shape, dtype=dtype)
    w = _randn(gen, shape[-1], dtype=wdtype)
    dy = _randn(gen, *shape, dtype=dtype)
    before = rmsnorm.bwd.launches
    dx, dw = ops.rms_norm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert rmsnorm.bwd.launches == before + 1
    want_dx, want_dw = rmsnorm.bwd_plain(x, w, dy)
    assert dx.dtype == dtype and dw.dtype == wdtype
    torch.testing.assert_close(dx, want_dx, **TOL[dtype])
    # dw sums over every row: fp32 partials in another order
    torch.testing.assert_close(dw.float(), want_dw.float(), atol=1e-3,
                               rtol=2.0 ** -6 if wdtype == torch.bfloat16
                               else 1e-4)


def _attn_inputs(gen, b, s, h, kvh, d, dtype):
    q = _randn(gen, b, s, h, d, dtype=dtype)
    k = _randn(gen, b, s, kvh, d, dtype=dtype)
    v = _randn(gen, b, s, kvh, d, dtype=dtype)
    return q, k, v


def _assert_cap_moves(q, k, v, do, kw, want_o, want):
    """The capped plain outputs differ from the uncapped ones by more than
    ten times REL_TOL, so the check above could see a kernel that
    ignored the cap or its derivative."""
    kw0 = dict(kw, cap=0.0)
    o0, lse0 = fa.flash_attention_plain(q, k, v, **kw0)
    want0 = fa.flash_attention_bwd_plain(q, k, v, o0, lse0, do, **kw0)
    for name, w0, w in zip(("o", "dq", "dk", "dv"), (o0,) + want0,
                           (want_o,) + want):
        assert _rel_err(w0, w)[0] > 10 * REL_TOL, name


@pytest.mark.parametrize("s,h,kvh,d,causal,window,cap", [
    (128, 4, 4, 128, True, 0, 0.0),
    (200, 8, 2, 64, True, 0, 0.0),
    (256, 4, 1, 128, True, 64, 0.0),
    (96, 4, 2, 64, True, 0, SOFTCAP),
    (160, 2, 2, 32, False, 0, 0.0),
    (130, 4, 4, 128, False, 40, SOFTCAP),
    (1024, 2, 2, 128, True, 0, 0.0),
    (2048, 4, 2, 128, True, 0, 0.0),
])
def test_flash_attention_kernels_match_plain(gen, s, h, kvh, d, causal,
                                             window, cap):
    dtype = torch.bfloat16
    q, k, v = _attn_inputs(gen, 2, s, h, kvh, d, dtype)
    kw = dict(causal=causal, window=window, scale=1 / math.sqrt(d), cap=cap)
    f0, b0 = fa.launches, fa.bwd.launches
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o, want_o, **TOL[dtype])
    _assert_rel_close(o, want_o, "o")
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    do = _randn(gen, *o.shape, dtype=dtype)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        _assert_rel_close(g, w, name)
    assert (fa.launches, fa.bwd.launches) == (f0 + 1, b0 + 1)
    if cap:
        _assert_cap_moves(q, k, v, do, kw, want_o, want)


def test_flash_attention_reads_strided_views(gen):
    """q, k, v as views of one fused [B, S, (H + 2 Kv) * D] projection,
    the layout a fused QKV matmul would give: no copy, same result."""
    b, s, h, kvh, d = 2, 96, 4, 2, 64
    qkv = _randn(gen, b, s, (h + 2 * kvh) * d, dtype=torch.bfloat16)
    q = qkv[..., :h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + kvh) * d].view(b, s, kvh, d)
    v = qkv[..., (h + kvh) * d:].view(b, s, kvh, d)
    assert not q.is_contiguous()
    o, _ = ops.flash_attention_fwd(q, k, v)
    want, _ = ops.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                      v.contiguous())
    torch.testing.assert_close(o, want, atol=0, rtol=0)


def test_training_functions_launch_the_kernels_under_backward(gen):
    q, k, v = (t.requires_grad_() for t in _attn_inputs(
        gen, 1, 64, 4, 2, 64, torch.bfloat16))
    x = _randn(gen, 64, 256, dtype=torch.bfloat16).requires_grad_()
    w = torch.ones(256, dtype=torch.bfloat16, device="cuda",
                   requires_grad=True)
    ops.reset_launch_counts()
    y = ops.rms_norm_fn(x, w)
    o = ops.flash_attention(q, k, v)
    (o.float().square().sum() + y.float().square().sum()).backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    assert counts["rms_norm"] == 1 and counts["rms_norm_bwd"] == 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v, x, w))


def test_training_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q, k, v = _attn_inputs(gen, 1, 64, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_fwd(*_attn_inputs(gen, 1, 64, 4, 2, 48,
                                              torch.bfloat16))
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_attention_fwd(q.float(), k, v)
    with pytest.raises(ValueError, match="bfloat16"):   # no fp32 kernels
        ops.flash_attention_fwd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention_bwd(*(t.float() for t in (q, k, v, q)),
                                torch.zeros(1, 4, 64, device="cuda"),
                                q.float())
    with pytest.raises(ValueError, match="heads over"):
        ops.flash_attention_fwd(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="strides"):
        ops.flash_attention_fwd(q.transpose(1, 3).contiguous().transpose(
            1, 3), k, v)
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_fwd(q, k, v, window=-1)
    x = _randn(gen, 8, 4096, dtype=torch.bfloat16)
    w = _randn(gen, 4096, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dy"):
        ops.rms_norm_bwd(x, w, x.float())
    with pytest.raises(ValueError, match="dtype"):
        ops.rms_norm_bwd(x.half(), w, x.half())


# -- matmul ------------------------------------------------------------------
# The kernel against its plain version (fp32 products with TF32 off, then
# one rounding to the promoted dtype).  Held by relative L2 error of the
# whole product and of its worst row and worst column (each over its norm
# plus 1 % of the median), so a zeroed or misplaced edge tile fails: fp32
# sums in another order (~sqrt(K) x 2^-24 relative): 1e-5 whole, 1e-4 per
# row / column; a bf16 output differs from the plain one by one bf16
# rounding (2^-9 relative): 1e-2 whole, 5e-2 per row / column.
MM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 5e-2)}


@pytest.fixture
def no_tf32(gen):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield gen
    torch.backends.cuda.matmul.allow_tf32 = prev


def _assert_mm_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    whole, worst = MM_TOL[got.dtype]
    for g, w in ((got, want), (got.transpose(-1, -2), want.transpose(-1, -2))):
        w_err, r_err = _rel_err(g, w)
        assert w_err <= whole and r_err <= worst, (w_err, r_err)


@pytest.mark.parametrize("m,k,n", [(4096, 768, 3072), (4096, 3072, 768),
                                   (4096, 768, 30522), (768, 4096, 3072),
                                   (144, 64, 10), (130, 33, 257), (1, 1, 1),
                                   (513, 4096, 129), (64, 17, 5)])
@pytest.mark.parametrize("ta,tb", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
def test_matmul_kernel_matches_plain(no_tf32, m, k, n, ta, tb):
    from repro_torch.kernels import matmul as mm

    a = _randn(no_tf32, m, k, dtype=ta)
    b = _randn(no_tf32, k, n, dtype=tb)
    before = mm.launches
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert mm.launches == before + 1
    _assert_mm_close(got, mm.plain(a, b))


@pytest.mark.parametrize("layout", ["a_T", "b_T", "both_T"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_reads_transposed_operands(no_tf32, layout, dtype):
    """The tape's backward operands: a^T @ g (K = 4096 rows of a Linear's
    input) and g @ w^T, as views whose last stride is not 1."""
    from repro_torch.kernels import matmul as mm

    m, k, n = 768, 4096, 3072
    a = _randn(no_tf32, k, m, dtype=dtype).t() if "a" in layout or \
        layout == "both_T" else _randn(no_tf32, m, k, dtype=dtype)
    b = _randn(no_tf32, n, k, dtype=dtype).t() if "b" in layout or \
        layout == "both_T" else _randn(no_tf32, k, n, dtype=dtype)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    _assert_mm_close(got, mm.plain(a, b))


@pytest.mark.parametrize("case", ["scores", "pv", "broadcast", "linear_3d",
                                  "four_batch_dims"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_batched_and_broadcast(no_tf32, case, dtype):
    from repro_torch.kernels import matmul as mm

    def r(*s):
        return _randn(no_tf32, *s, dtype=dtype)

    a, b = {
        "scores": lambda: (r(8, 12, 512, 64), r(8, 12, 512, 64).transpose(
            -1, -2)),
        "pv": lambda: (r(8, 12, 512, 512), r(8, 12, 512, 64)),
        "broadcast": lambda: (r(3, 1, 100, 70), r(5, 70, 33)),
        "linear_3d": lambda: (r(8, 512, 768), r(768, 30522)[:, :3000]),
        "four_batch_dims": lambda: (r(2, 3, 2, 2, 40, 24),
                                    r(2, 1, 2, 2, 24, 56)),
    }[case]()
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    _assert_mm_close(got, mm.plain(a, b))


def test_hopper_backend_runs_the_kernel_on_the_card(no_tf32):
    import repro_torch
    from repro_torch.core.tensor import HopperBackend
    from repro_torch.core.tensor import ops as tops
    from repro_torch.kernels import matmul as mm

    backend = HopperBackend()
    a = _randn(no_tf32, 4, 64, 48)
    w = _randn(no_tf32, 48, 40)
    before = mm.launches
    with repro_torch.session(backend=backend):
        got = tops.matmul(a, w)
    torch.cuda.synchronize()
    assert mm.launches == before + 1 and backend.kernel_calls == 1
    _assert_mm_close(got, mm.plain(a, w))


def test_matmul_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    a = torch.ones(4, 4, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        ops.matmul(a, a)
    with pytest.raises(ValueError, match="contract"):
        ops.matmul(_randn(gen, 4, 5), _randn(gen, 4, 5))
    with pytest.raises(ValueError, match="several devices"):
        ops.matmul(_randn(gen, 4, 4), torch.ones(4, 4))
