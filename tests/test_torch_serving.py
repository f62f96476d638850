"""The port's ``ServeEngine`` against the JAX ``ServeEngine`` on the
paged KV cache: the same converted weights, the ``examples/serve_lm.py``
prompts, and token-identical greedy output (float32; a flip would need
two logits within ~1e-6 of each other).  One pool is roomy; a small one
forces preemption and requeue.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import build_model
from repro.runtime import ServingPolicy as JaxPolicy
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.runtime import ServingPolicy
from repro_torch.serving import (OutOfMemory, PagedKVCache, Request,
                                 ServeEngine)

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7],
           [2, 7, 1, 8], [2, 8, 1], [8, 2, 8, 4]]


@pytest.fixture(scope="module")
def models():
    jm = build_model(jax_config("codeqwen1.5-7b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(get_config("codeqwen1.5-7b", reduced=True), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _drive(engine, request_cls, max_new=12):
    for uid, p in enumerate(PROMPTS):
        engine.submit(request_cls(uid=uid, prompt=p, max_new_tokens=max_new))
    done = engine.run_until_done()
    assert len(done) == len(PROMPTS)
    return {r.uid: r.generated for r in done}


@pytest.mark.parametrize("num_blocks,scheduler", [(None, "fifo"),
                                                  (None, "sjf"),
                                                  (6, "fifo")])
def test_engine_tokens_identical_to_reference(models, num_blocks, scheduler):
    jm, jp, tm, tp = models
    kw = dict(cache="paged", block_size=8, prefill_chunk=8,
              num_blocks=num_blocks, scheduler=scheduler)
    ref = JaxEngine(jm, jp, batch_slots=4, max_seq=64, policy=JaxPolicy(**kw))
    port = ServeEngine(tm, tp, batch_slots=4, max_seq=64,
                       policy=ServingPolicy(**kw))
    want = _drive(ref, JaxRequest)
    got = _drive(port, Request)
    assert got == want
    assert port.preemptions == ref.preemptions
    assert (port.preemptions > 0) == (num_blocks is not None)
    assert port.prefill_calls == ref.prefill_calls
    assert port.decode_calls == ref.decode_calls
    assert port.kv.blocks_in_use == 0
    assert port.describe()["kv_cache"]["blocks_in_use"] == 0


def test_engine_refuses_what_is_not_ported(models):
    _, _, tm, tp = models
    for policy in (ServingPolicy(cache="dense"), ServingPolicy(prefix=True),
                   ServingPolicy(speculative={"enabled": True,
                                              "draft": "model"}),
                   ServingPolicy(prefill_chunk=0)):
        with pytest.raises(NotImplementedError):
            ServeEngine(tm, tp, batch_slots=2, max_seq=32, policy=policy)


def test_engine_rejects_models_without_a_paged_cache(models):
    _, _, tm, tp = models

    class LatentCacheModel:
        cfg, device = tm.cfg, tm.device

        def supports_paged_cache(self):
            return False

    with pytest.raises(ValueError, match="paged KV cache"):
        ServeEngine(LatentCacheModel(), tp, batch_slots=2, max_seq=32)


def test_request_larger_than_the_pool_raises(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, batch_slots=2, max_seq=64,
                      policy=ServingPolicy(block_size=4, num_blocks=3))
    eng.submit(Request(uid=0, prompt=list(range(20)), max_new_tokens=2))
    with pytest.raises(OutOfMemory):
        eng.run_until_done()


def test_paged_cache_block_accounting(models):
    _, _, tm, _ = models
    kv = PagedKVCache(tm, slots=2, max_seq=32, block_size=4, num_blocks=5)
    assert kv.usable_blocks == 4
    kv.ensure(0, 6)                          # positions 0..6: 2 blocks
    kv.ensure(1, 3)
    assert kv.blocks_in_use == 3 and (kv.table[0, :2] > 0).all()
    kv.ensure(1, 7)
    with pytest.raises(OutOfMemory):
        kv.ensure(0, 8)
    kv.release(1)
    assert kv.blocks_in_use == 2 and not kv.table[1].any()
    kv.ensure(0, 15)
    assert kv.blocks_in_use == 4
    bt = kv.device_table()
    assert bt.table.dtype == torch.int32 and bt.table.shape == (2, 8)
    kv.table[0, 0] = 99                      # the device copy is detached
    assert int(bt.table[0, 0]) != 99
    assert kv.pools[0]["k"].shape == (3, 5 * 4, 4, 16)
