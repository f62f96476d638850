"""The port's Session (the cases of tests/test_runtime_session.py and
tests/test_deprecation_shims.py): stack semantics, thread isolation,
the deprecated shims, provenance, kernel and precision overrides, and the
fields and backends that are not ported yet, which must raise naming
their ROADMAP item."""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.core.tensor import current_backend, get_backend, ops
from repro_torch.core.tensor.dispatch import set_backend, use_backend
from repro_torch.runtime import (KernelOverrides, PrecisionPolicy, Session,
                                 ServingPolicy)
from repro_torch.runtime import stack as _rt


# -- stack semantics ---------------------------------------------------------

def test_default_session_is_torch():
    s = repro_torch.current_session()
    assert s.backend == "torch"
    assert s.backend_instance().name == "torch"
    assert repro_torch.default_session().backend == "torch"


def test_nesting_composes_and_restores():
    with repro_torch.session(backend="hopper") as outer:
        assert current_backend().name == "hopper"
        with repro_torch.session(tag="inner") as inner:
            assert inner.backend == "hopper"
            assert inner.tag == "inner"
        assert repro_torch.current_session() is outer
    assert current_backend().name == "torch"


def test_restore_on_exception():
    before = repro_torch.current_session()
    with pytest.raises(RuntimeError, match="boom"):
        with repro_torch.session(backend="hopper"):
            raise RuntimeError("boom")
    assert repro_torch.current_session() is before


def test_enter_explicit_session_verbatim():
    s = Session(backend="hopper", tag="explicit")
    with repro_torch.session(s) as active:
        assert active is s
        assert current_backend().name == "hopper"
    with pytest.raises(TypeError):
        with repro_torch.session("hopper"):
            pass


def test_replace_accepts_nested_dicts():
    s = Session()
    s2 = s.replace(kernels={"matmul": np.matmul},
                   precision={"compute_dtype": "bf16"},
                   serving={"prefill_chunk": 64})
    assert s2.kernels.matmul is np.matmul
    assert s2.kernels.decode_attention is None
    assert s2.precision.compute_dtype == "bf16"
    assert s2.serving.prefill_chunk == 64 and s2.serving.cache == "paged"
    assert s.kernels.matmul is None


def test_thread_isolation():
    seen = {}

    def worker():
        seen["backend"] = repro_torch.current_session().backend
        with repro_torch.session(backend="hopper"):
            seen["scoped"] = repro_torch.current_session().backend

    with repro_torch.session(backend="hopper", tag="main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert repro_torch.current_session().tag == "main"
    assert seen == {"backend": "torch", "scoped": "hopper"}


# -- deprecated shims --------------------------------------------------------

def test_use_backend_warns_and_rides_session_stack():
    depth = len(_rt._STACK.stack)
    before = repro_torch.current_session()
    with pytest.warns(DeprecationWarning, match="use_backend"):
        with use_backend("hopper") as b:
            assert b is get_backend("hopper")
            assert current_backend() is b
            assert len(_rt._STACK.stack) == depth + 1
    assert repro_torch.current_session() is before


def test_set_backend_warns_and_mutates_current_scope():
    with repro_torch.session():
        with pytest.warns(DeprecationWarning, match="set_backend"):
            set_backend("hopper")
        assert repro_torch.current_session().backend == "hopper"
    assert current_backend().name == "torch"


def test_shims_compose_with_modern_sessions():
    with repro_torch.session(tag="outer") as outer:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with use_backend("torch"):
                assert repro_torch.current_session().tag == "outer"
        assert repro_torch.current_session() is outer


# -- provenance --------------------------------------------------------------

def test_describe_round_trip_and_matches_reference_keys():
    s = Session(backend="hopper",
                kernels=KernelOverrides(matmul=np.matmul),
                precision=PrecisionPolicy(compute_dtype="bf16"), tag="prov")
    d = s.describe()
    assert json.loads(json.dumps(d)) == d
    assert d["backend"] == "hopper" and d["tag"] == "prov"
    assert d["kernels"]["matmul"].endswith("matmul")
    assert d["precision"]["compute_dtype"] == "bf16"
    ref = repro.runtime.Session(precision=repro.runtime.PrecisionPolicy(
        compute_dtype="bf16")).describe()
    assert d["precision"] == ref["precision"]
    assert set(d["kernels"]) == set(ref["kernels"])


# -- overrides ---------------------------------------------------------------

def test_matmul_kernel_override_scoped():
    calls = []

    def spy(lhs, rhs):
        calls.append(tuple(lhs.shape))
        return torch.matmul(lhs, rhs)

    a = torch.ones(4, 4)
    with repro_torch.session(kernels={"matmul": spy}):
        out = ops.matmul(a, a)
    assert calls == [(4, 4)]
    np.testing.assert_allclose(out.numpy(), 4.0 * np.ones((4, 4)))
    ops.matmul(a, a)
    assert len(calls) == 1


def test_precision_policy_applies_to_get_config():
    from repro_torch.configs import get_config

    # the full config's default is bf16 (a config, no weights)
    with repro_torch.session(precision={"compute_dtype": "f32",
                                        "param_dtype": "fp32"}):
        cfg = get_config("codeqwen1.5-7b")
    assert cfg.compute_dtype == torch.float32
    assert cfg.param_dtype == torch.float32
    # explicit get_config overrides still beat the policy
    with repro_torch.session(precision={"compute_dtype": "f32"}):
        cfg = get_config("codeqwen1.5-7b", compute_dtype=torch.float16)
    assert cfg.compute_dtype == torch.float16
    assert cfg.param_dtype == torch.bfloat16
    # no leakage outside the scope
    assert get_config("codeqwen1.5-7b").compute_dtype == torch.bfloat16
    with repro_torch.session(precision={"cache_dtype": "fp8"}):
        with pytest.raises(NotImplementedError, match="item 2"):
            get_config("codeqwen1.5-7b", reduced=True)


def test_attention_override_reaches_the_model():
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.attention import _sdpa_ref, make_mask

    cfg = get_config("codeqwen1.5-7b", reduced=True, n_layers=1,
                     d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                     vocab_size=32, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    model = LM(cfg, device="cpu")
    params = model.init(0)
    hits = []

    def attend(q, k, v, *, positions, causal, window, prefix_len, scale,
               cap):
        hits.append(tuple(q.shape))
        mask = make_mask(positions, positions, causal=causal, window=window,
                         prefix_len=prefix_len)
        return _sdpa_ref(q, k, v, mask, scale, cap)

    toks = torch.zeros(1, 8, dtype=torch.long)
    with repro_torch.session(kernels={"attention": attend}):
        with torch.no_grad():
            model.forward(params, toks)
    assert hits == [(1, 8, 2, 16)]


def test_serve_engine_reads_the_session_and_refuses_decode_override():
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serving import ServeEngine

    cfg = get_config("codeqwen1.5-7b", reduced=True, n_layers=1)
    model = LM(cfg, device="cpu")
    params = model.init(0)
    with repro_torch.session(serving={"prefill_chunk": 8, "block_size": 4}):
        engine = ServeEngine(model, params, batch_slots=2, max_seq=32)
    assert engine.policy.prefill_chunk == 8
    assert engine.policy.block_size == 4
    assert ServeEngine(model, params, batch_slots=2,
                       max_seq=32).policy == ServingPolicy()
    with repro_torch.session(kernels={"decode_attention": lambda *a: a}):
        with pytest.raises(NotImplementedError, match="item 2"):
            ServeEngine(model, params, batch_slots=2, max_seq=32)


# -- what is not ported yet --------------------------------------------------

@pytest.mark.parametrize("field,value,item", [
    ("mesh", object(), "item 10"),
    ("batch_axes", ("data",), "item 10"),
    ("sharding_rules", "fsdp", "item 10"),
    ("compiler", {"pipeline": ()}, "item 7"),
    ("analysis", {"level": "strict"}, "item 8"),
    ("obs", True, "item 3"),
    ("memory", object(), "item 3"),
    ("backend", "lazy", "item 7"),
])
def test_unported_fields_raise_naming_their_item(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        Session(**{field: value})
    with pytest.raises(NotImplementedError, match=item):
        with repro_torch.session(**{field: value}):
            pass
    assert repro_torch.current_session() is repro_torch.default_session()


def test_unported_fields_accept_their_defaults():
    s = Session(mesh=None, batch_axes=("pod", "data"), obs=False,
                compiler=None, analysis=None, memory=None)
    assert s.describe()["backend"] == "torch"
