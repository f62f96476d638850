"""The port's tensor layer against the JAX package's: every
``TensorBackend`` primitive of ``TorchBackend`` (and ``HopperBackend``,
which inherits all but matmul) against ``JnpBackend`` on the same inputs,
every derived op of ``ops`` under each package's default session, and the
registry.

Inputs come from a seeded numpy generator.  Tolerances: float32 results
to 1e-6 relative (two implementations of a transcendental differ by an
ulp or two, 1.2e-7 each), with an absolute floor of 1e-6 times the
largest magnitude of the result for sums and contractions, whose
summation order differs; integer and boolean results exactly.  The random
primitives draw from different generators (a JAX key, a torch.Generator)
and are held by shape, dtype, range and moments instead.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tensor import ops as jops
from repro.core.tensor.backend import TensorBackend as JaxTensorBackend
from repro.core.tensor.jnp_backend import JnpBackend
from repro_torch.core.tensor import (HopperBackend, TensorBackend,
                                     TorchBackend, available_backends,
                                     current_backend, get_backend)
from repro_torch.core.tensor import ops as tops

RTOL = 1e-6
ATOL_SCALE = 1e-6


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _i32(rng, *shape, lo=-5, hi=6):
    return rng.integers(lo, hi, shape).astype(np.int32)


def _to_jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_torch(a):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a.copy())
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        return [torch.from_numpy(x.copy()) for x in a]
    return a


def _jax_list(a):
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        return [jnp.asarray(x) for x in a]
    return _to_jax(a)


def assert_same(got, want):
    """Hold a port result (torch) against the reference's (jax)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    w = np.asarray(want)
    g = got.detach().cpu().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype.kind in "biu":
        assert g.dtype.kind == w.dtype.kind or (w.dtype.kind, g.dtype.kind) \
            in (("i", "u"), ("u", "i")), (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)
    else:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL_SCALE * max(scale, 1.0))


# name -> a function of a numpy generator returning the primitive's
# arguments (numpy arrays become jax / torch tensors; everything else
# passes as it is)
PRIMITIVES = {
    "neg": lambda r: [_f32(r, 4, 5)],
    "exp": lambda r: [_f32(r, 4, 5)],
    "log": lambda r: [np.abs(_f32(r, 4, 5)) + 0.1],
    "sin": lambda r: [_f32(r, 4, 5)],
    "cos": lambda r: [_f32(r, 4, 5)],
    "tanh": lambda r: [_f32(r, 4, 5)],
    "sqrt": lambda r: [np.abs(_f32(r, 4, 5))],
    "rsqrt": lambda r: [np.abs(_f32(r, 4, 5)) + 0.1],
    "abs": lambda r: [_f32(r, 4, 5)],
    "sign": lambda r: [np.concatenate([_f32(r, 4, 5), np.zeros((1, 5),
                                                               np.float32)])],
    "floor": lambda r: [3 * _f32(r, 4, 5)],
    "erf": lambda r: [_f32(r, 4, 5)],
    "logical_not": lambda r: [_f32(r, 4, 5) > 0],
    "isnan": lambda r: [np.where(_f32(r, 4, 5) > 1, np.nan,
                                 1.0).astype(np.float32)],
    "add": lambda r: [_f32(r, 4, 5), _f32(r, 1, 5)],
    "sub": lambda r: [_f32(r, 4, 5), _f32(r, 4, 1)],
    "mul": lambda r: [_f32(r, 4, 5), _f32(r, 4, 5)],
    "div": lambda r: [_f32(r, 4, 5), np.abs(_f32(r, 4, 5)) + 0.5],
    "pow": lambda r: [np.abs(_f32(r, 4, 5)) + 0.1, _f32(r, 4, 5)],
    "maximum": lambda r: [_f32(r, 4, 5), _f32(r, 5)],
    "minimum": lambda r: [_f32(r, 4, 5), _f32(r, 5)],
    "mod": lambda r: [4 * _f32(r, 4, 5), np.abs(_f32(r, 4, 5)) + 0.5],
    "eq": lambda r: [_i32(r, 4, 5, lo=0, hi=3), _i32(r, 4, 5, lo=0, hi=3)],
    "ne": lambda r: [_i32(r, 4, 5, lo=0, hi=3), _i32(r, 4, 5, lo=0, hi=3)],
    "lt": lambda r: [_i32(r, 4, 5, lo=0, hi=3), _i32(r, 4, 5, lo=0, hi=3)],
    "le": lambda r: [_f32(r, 4, 5), _f32(r, 4, 5)],
    "gt": lambda r: [_f32(r, 4, 5), _f32(r, 4, 5)],
    "ge": lambda r: [_i32(r, 4, 5, lo=0, hi=3), _i32(r, 4, 5, lo=0, hi=3)],
    "logical_and": lambda r: [_f32(r, 4, 5) > 0, _f32(r, 4, 5) > 0],
    "logical_or": lambda r: [_f32(r, 4, 5) > 0, _f32(r, 4, 5) > 0],
    "sum": lambda r: [_f32(r, 3, 4, 5), (0, 2), True],
    "max": lambda r: [_f32(r, 3, 4, 5), 1, False],
    "min": lambda r: [_f32(r, 3, 4, 5), None, False],
    "prod": lambda r: [0.5 + np.abs(_f32(r, 3, 4, 5)), (1, 2), False],
    "argmax": lambda r: [_f32(r, 4, 7), -1],
    "cumsum": lambda r: [_f32(r, 4, 7), 1],
    "reshape": lambda r: [_f32(r, 4, 6), (2, 12)],
    "transpose": lambda r: [_f32(r, 2, 3, 4), (2, 0, 1)],
    "broadcast_to": lambda r: [_f32(r, 1, 4), (3, 4)],
    "concatenate": lambda r: [[_f32(r, 2, 3), _f32(r, 4, 3)], 0],
    "slice": lambda r: [_f32(r, 5, 6), (1, 2), (4, 5)],
    "dynamic_slice": lambda r: [_f32(r, 5, 6), (4, 1), (3, 2)],
    "dynamic_update_slice": lambda r: [_f32(r, 5, 6), _f32(r, 2, 3),
                                       (1, 5)],
    "pad": lambda r: [_f32(r, 3, 4), ((1, 2), (0, 3)), 0.5],
    "where": lambda r: [_f32(r, 4, 5) > 0, _f32(r, 4, 5), _f32(r, 4, 5)],
    "take": lambda r: [_f32(r, 6, 3), _i32(r, 2, 4, lo=0, hi=6), 0],
    "take_along_axis": lambda r: [_f32(r, 4, 6), _i32(r, 4, 2, lo=0, hi=6),
                                  1],
    "scatter_add": lambda r: [_f32(r, 6, 3), _i32(r, 5, lo=0, hi=6),
                              _f32(r, 5, 3), 0],
    "flip": lambda r: [_f32(r, 3, 4), 1],
    "sort": lambda r: [_f32(r, 3, 6), -1],
    "top_k": lambda r: [_f32(r, 3, 8), 3],
    "astype": lambda r: [3 * _f32(r, 3, 4), "int32"],
    "stop_gradient": lambda r: [_f32(r, 3, 4)],
    "matmul": lambda r: [_f32(r, 2, 5, 8), _f32(r, 8, 3)],
    "dot_general": lambda r: [_f32(r, 2, 5, 8), _f32(r, 2, 8, 3),
                              (((2,), (1,)), ((0,), (0,))), None],
    "conv2d": lambda r: [_f32(r, 2, 7, 7, 3), 0.3 * _f32(r, 3, 3, 3, 4),
                         (2, 2), "SAME"],
}

# extra cases of the same primitives: integer arithmetic (exact), other
# axes and the remaining layouts
EXTRA = {
    "add_i32": ("add", lambda r: [_i32(r, 4, 5), _i32(r, 4, 5)]),
    "mul_i32": ("mul", lambda r: [_i32(r, 4, 5), _i32(r, 4, 5)]),
    "mod_i32": ("mod", lambda r: [_i32(r, 4, 5), _i32(r, 4, 5, lo=1)]),
    "maximum_i32": ("maximum", lambda r: [_i32(r, 4, 5), _i32(r, 4, 5)]),
    "sum_i32_all": ("sum", lambda r: [_i32(r, 3, 4), None, False]),
    "sum_bool": ("sum", lambda r: [_f32(r, 3, 4) > 0, 1, False]),
    "sum_all_keepdims": ("sum", lambda r: [_f32(r, 3, 4), None, True]),
    "prod_i32": ("prod", lambda r: [_i32(r, 3, 4, lo=1, hi=4), 0, True]),
    "cumsum_i32": ("cumsum", lambda r: [_i32(r, 3, 5), 0]),
    "argmax_axis0": ("argmax", lambda r: [_f32(r, 5, 3), 0]),
    "transpose_none": ("transpose", lambda r: [_f32(r, 2, 3, 4), None]),
    "flip_all": ("flip", lambda r: [_f32(r, 3, 4), None]),
    "take_axis1": ("take", lambda r: [_f32(r, 3, 6, 2),
                                      _i32(r, 4, lo=0, hi=6), 1]),
    "scatter_add_axis1": ("scatter_add", lambda r: [
        _f32(r, 3, 6), _i32(r, 2, 2, lo=0, hi=6), _f32(r, 3, 2, 2), 1]),
    "matmul_2d": ("matmul", lambda r: [_f32(r, 5, 8), _f32(r, 8, 3)]),
    "matmul_broadcast": ("matmul", lambda r: [_f32(r, 2, 1, 5, 8),
                                              _f32(r, 3, 8, 3)]),
    "dot_general_linear": ("dot_general", lambda r: [
        _f32(r, 2, 5, 8), _f32(r, 8, 3), (((2,), (0,)), ((), ())), None]),
    "dot_general_transposed": ("dot_general", lambda r: [
        _f32(r, 8, 5), _f32(r, 3, 8), (((0,), (1,)), ((), ())), None]),
    "conv2d_same_stride1": ("conv2d", lambda r: [
        _f32(r, 2, 6, 6, 1), 0.3 * _f32(r, 3, 3, 1, 8), (1, 1), "SAME"]),
    "conv2d_valid": ("conv2d", lambda r: [
        _f32(r, 2, 6, 5, 2), 0.3 * _f32(r, 2, 3, 2, 3), (1, 2), "VALID"]),
    "pad_i32": ("pad", lambda r: [_i32(r, 3, 2), ((0, 1), (2, 0)), 7]),
}

CASES = {name: (name, build) for name, build in PRIMITIVES.items()}
CASES.update(EXTRA)

_DTYPES = {"int32": (jnp.int32, torch.int32)}


def test_primitive_surface_is_the_references():
    assert set(TensorBackend.primitive_ops()) == set(
        JaxTensorBackend.primitive_ops())
    prims = TensorBackend.primitive_ops()
    assert 40 <= len(prims) <= 80
    assert prims.count("add") == 1 and prims.count("sum") == 1
    assert sum(1 for p in prims if p.startswith("conv")) == 1


def test_cases_cover_every_primitive():
    creation = {"full", "arange", "iota", "random_uniform", "random_normal"}
    covered = {prim for prim, _ in CASES.values()} | creation
    assert covered == set(TensorBackend.primitive_ops())


@pytest.mark.parametrize("backend", [TorchBackend, HopperBackend])
@pytest.mark.parametrize("case", sorted(CASES))
def test_primitive_matches_jnp_backend(case, backend):
    prim, build = CASES[case]
    args = build(np.random.default_rng(zlib.crc32(case.encode())))
    jargs = [_jax_list(a) for a in args]
    targs = [_to_torch(a) for a in args]
    if prim == "astype":
        jargs[1], targs[1] = _DTYPES[args[1]]
    want = getattr(JnpBackend(), prim)(*jargs)
    got = getattr(backend(), prim)(*targs)
    assert_same(got, want)


@pytest.mark.parametrize("case", ["full", "arange", "iota"])
def test_creation_primitives_match(case):
    jb, tb = JnpBackend(), TorchBackend()
    if case == "full":
        want = jb.full((3, 4), 2.5, jnp.float32)
        got = tb.full((3, 4), 2.5, torch.float32, "cpu")
    elif case == "arange":
        want = jb.arange(2, 17, 3, jnp.int32)
        got = tb.arange(2, 17, 3, torch.int32, "cpu")
    else:
        want = jb.iota(jnp.int32, (3, 4, 5), 1)
        got = tb.iota(torch.int32, (3, 4, 5), 1, "cpu")
    assert_same(got, want)


@pytest.mark.parametrize("prim", ["random_uniform", "random_normal"])
def test_random_primitives_shape_dtype_moments(prim):
    """Different generators: hold shape, dtype, range and moments; the
    same seed gives the same draw."""
    tb = TorchBackend()

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        if prim == "random_uniform":
            return tb.random_uniform(gen, (200, 100), torch.float32, -2.0,
                                     3.0, "cpu")
        return tb.random_normal(gen, (200, 100), torch.float32, "cpu")

    x = draw(7)
    assert x.shape == (200, 100) and x.dtype == torch.float32
    assert torch.equal(x, draw(7)) and not torch.equal(x, draw(8))
    if prim == "random_uniform":
        assert float(x.min()) >= -2.0 and float(x.max()) < 3.0
        assert abs(float(x.mean()) - 0.5) < 0.05
    else:
        assert abs(float(x.mean())) < 0.03
        assert abs(float(x.std()) - 1.0) < 0.03


# derived ops, through ops under each package's default session
DERIVED = {
    "relu": lambda r: [_f32(r, 4, 5)],
    "sigmoid": lambda r: [_f32(r, 4, 5)],
    "silu": lambda r: [_f32(r, 4, 5)],
    "gelu": lambda r: [_f32(r, 4, 5)],
    "softplus": lambda r: [3 * _f32(r, 4, 5)],
    "mean": lambda r: [_f32(r, 3, 4, 5), (0, 2)],
    "var": lambda r: [_f32(r, 3, 4, 5), -1],
    "softmax": lambda r: [3 * _f32(r, 4, 7)],
    "log_softmax": lambda r: [3 * _f32(r, 4, 7)],
    "logsumexp": lambda r: [3 * _f32(r, 4, 7)],
    "one_hot": lambda r: [_i32(r, 2, 5, lo=0, hi=6), 6],
    "rms_norm": lambda r: [_f32(r, 4, 8), _f32(r, 8)],
    "layer_norm": lambda r: [_f32(r, 4, 8), _f32(r, 8), _f32(r, 8)],
    "clip": lambda r: [_f32(r, 4, 5), -0.5, 0.7],
    "square": lambda r: [_f32(r, 4, 5)],
    "zeros_like": lambda r: [_f32(r, 4, 5)],
    "ones_like": lambda r: [_f32(r, 4, 5)],
    "full_like": lambda r: [_f32(r, 4, 5), 3.25],
}


@pytest.mark.parametrize("op", sorted(DERIVED))
def test_derived_op_matches_reference(op):
    args = DERIVED[op](np.random.default_rng(zlib.crc32(op.encode())))
    want = getattr(jops, op)(*[_to_jax(a) for a in args])
    got = getattr(tops, op)(*[_to_torch(a) for a in args])
    assert_same(got, want)


def test_dropout_mask_keeps_scaled_fraction():
    gen = torch.Generator().manual_seed(3)
    m = tops.dropout_mask(gen, (400, 100), 0.25, device="cpu")
    kept = m != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    np.testing.assert_allclose(m[kept].numpy(), 1 / 0.75, rtol=1e-6)


def test_default_backend_and_registry():
    assert current_backend().name == "torch"
    assert {"torch", "hopper", "lazy"} <= set(available_backends())
    assert isinstance(get_backend("hopper"), HopperBackend)
    with pytest.raises(KeyError):
        get_backend("no-such-backend")
    with pytest.raises(NotImplementedError, match="item 7"):
        get_backend("lazy")


def test_creation_defaults_to_the_card():
    import inspect

    for fn in (tops.full, tops.zeros, tops.ones, tops.arange, tops.iota,
               tops.random_uniform, tops.random_normal):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
