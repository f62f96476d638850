"""The port's speculative decoding against its own plain decode and the
JAX ``ServeEngine`` with speculation on, mirroring
tests/test_serving_speculative.py: the same converted weights, prompts
and proposers, and token-identical greedy streams (float32; a flip
would need two logits within ~1e-6 of each other).  Every run must end
with no decode call, no block in use and an all-zero table, and count
the reference's accepted and rejected proposals.
"""

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jax_config
from repro.models import build_model
from repro.runtime import ServingPolicy as JaxPolicy
from repro.serving import FixedProposer as JaxFixed
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.runtime import ServingPolicy
from repro_torch.serving import (FixedProposer, PagedKVCache, Request,
                                 ServeEngine)

PROMPTS = [[3, 1, 4, 1, 5], [9, 2], [5, 3, 5, 8, 9, 7, 2], [2, 7, 1, 8]]
BASE = dict(cache="paged", block_size=4, prefill_chunk=8)
SPEC = dict(BASE, speculative={"enabled": True, "k": 4})
TINY = dict(reduced=True, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=64)


@pytest.fixture(scope="module")
def tiny():
    jm = build_model(jax_config("codeqwen1.5-7b", **TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(get_config("codeqwen1.5-7b", **TINY), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _run(engine_cls, request_cls, model, params, policy, *, max_new=12,
         slots=4, stagger=False, proposer=None):
    eng = engine_cls(model, params, batch_slots=slots, max_seq=64,
                     policy=policy, proposer=proposer)
    reqs = [request_cls(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(PROMPTS)]
    rest = reqs
    if stagger:
        eng.submit(reqs[0])
        eng.step()
        eng.step()
        rest = reqs[1:]
    for r in rest:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return {r.uid: r.generated for r in reqs}, eng


def _both(tiny, kw, *, proposer_fn=None, **run_kw):
    """(port tokens, port engine, reference tokens, reference engine) for
    one policy; ``proposer_fn`` builds the same proposals in both."""
    jm, jp, tm, tp = tiny
    ref = _run(JaxEngine, JaxRequest, jm, jp, JaxPolicy(**kw),
               proposer=None if proposer_fn is None else JaxFixed(
                   proposer_fn), **run_kw)
    got = _run(ServeEngine, Request, tm, tp, ServingPolicy(**kw),
               proposer=None if proposer_fn is None else FixedProposer(
                   proposer_fn), **run_kw)
    return got + ref


def _check_spec_end(eng, ref_eng):
    d, want = eng.describe()["speculative"], ref_eng.describe()["speculative"]
    assert d["enabled"] and eng.decode_calls == 0
    assert eng.kv.blocks_in_use == 0 and not eng.kv.table.any()
    for key in ("rounds", "slot_rounds", "verify_calls", "accepted_tokens",
                "rejected_tokens", "accepted_per_step"):
        assert d[key] == want[key], key
    assert set(d) == set(want)
    return d


def _sequences(ref):
    return [list(p) + list(ref[uid]) for uid, p in enumerate(PROMPTS)]


def _oracle(ref):
    """Replay the plain continuation: every proposal is accepted."""
    seqs = _sequences(ref)

    def fn(ctx):
        for seq in seqs:
            if len(seq) >= len(ctx) and seq[:len(ctx)] == ctx:
                return seq[len(ctx):]
        return []
    return fn


def _adversary(ref, k):
    """Propose exactly the wrong token: acceptance 0 every round."""
    seqs = _sequences(ref)

    def fn(ctx):
        for seq in seqs:
            if len(seq) > len(ctx) and seq[:len(ctx)] == ctx:
                return [(seq[len(ctx)] + 1) % 64] * k
        return []
    return fn


@pytest.fixture(scope="module")
def plain(tiny):
    """The port's plain runs, staggered and not."""
    _, _, tm, tp = tiny
    return {st: _run(ServeEngine, Request, tm, tp, ServingPolicy(**BASE),
                     stagger=st) for st in (False, True)}


def test_ngram_speculation_is_identical_to_plain_and_reference(tiny, plain):
    got, eng, ref, ref_eng = _both(tiny, SPEC, stagger=True)
    assert got == plain[True][0] == ref
    d = _check_spec_end(eng, ref_eng)
    assert d["verify_calls"] > 0
    assert d["proposer"] == {"kind": "NGramProposer", "n": 3}


def test_oracle_proposals_are_all_accepted(tiny, plain):
    ref_plain, plain_eng = plain[False]
    rounds = []

    class Recording(FixedProposer):
        def propose(self, contexts, k):
            self.last = super().propose(contexts, k)
            return self.last

        def commit(self, accepted):
            rounds.append({s: (len(self.last[s]), a)
                           for s, a in accepted.items()})

    _, _, tm, tp = tiny
    got, eng = _run(ServeEngine, Request, tm, tp, ServingPolicy(**SPEC),
                    proposer=Recording(_oracle(ref_plain)))
    jm, jp = tiny[:2]
    ref, ref_eng = _run(JaxEngine, JaxRequest, jm, jp, JaxPolicy(**SPEC),
                        proposer=JaxFixed(_oracle(ref_plain)))
    assert got == ref == ref_plain
    d = _check_spec_end(eng, ref_eng)
    # acceptance is k in every round where the oracle had k tokens left
    assert rounds and all(a == n for r in rounds for n, a in r.values())
    full = [a for r in rounds for n, a in r.values() if n == 4]
    assert full and all(a == 4 for a in full)
    assert d["rejected_tokens"] == 0 and d["accepted_per_step"] > 2.0
    assert d["verify_calls"] < plain_eng.decode_calls


def test_adversarial_proposals_are_all_rejected(tiny, plain):
    ref_plain = plain[False][0]
    got, eng, ref, ref_eng = _both(tiny, SPEC,
                                   proposer_fn=_adversary(ref_plain, 4))
    assert got == ref == ref_plain
    d = _check_spec_end(eng, ref_eng)
    assert d["accepted_tokens"] == 0 and d["rejected_tokens"] > 0
    assert eng.kv.rollback_blocks_freed > 0   # rejected spans crossed blocks


def test_preemption_mid_speculation_requeues_identically(tiny):
    """A tight pool (block 4, 9 blocks, 3 slots) evicts between rounds;
    re-admission must catch the victim up: the same tokens as the plain
    run and the reference."""
    _, _, tm, tp = tiny
    tight = dict(BASE, num_blocks=9)
    want, off = _run(ServeEngine, Request, tm, tp, ServingPolicy(**tight),
                     max_new=14, slots=3)
    got, eng, ref, ref_eng = _both(
        tiny, dict(tight, speculative={"enabled": True, "k": 4}),
        max_new=14, slots=3)
    assert got == ref == want
    assert eng.preemptions == ref_eng.preemptions
    assert eng.preemptions + off.preemptions > 0
    _check_spec_end(eng, ref_eng)


def test_speculation_stays_off_for_a_model_without_rollback(tiny, plain):
    _, _, tm, tp = tiny

    class NoRollback(LM):
        def supports_speculative(self):
            return False

    model = NoRollback(tm.cfg, device="cpu")
    got, eng = _run(ServeEngine, Request, model, tp, ServingPolicy(**SPEC))
    assert got == plain[False][0]
    assert not eng.spec_on and eng.decode_calls > 0
    assert eng.describe()["speculative"]["verify_calls"] == 0


def test_rollback_frees_trailing_blocks(tiny):
    _, _, tm, _ = tiny
    kv = PagedKVCache(tm, slots=2, max_seq=32, block_size=4, num_blocks=9)
    kv.ensure(0, 13)                         # positions 0..13: 4 blocks
    kv.ensure(1, 2)
    kept = kv.table[0, :2].copy()
    kv.begin_write(0, 9, 13)
    assert kv.prepare_write(0, 9, 13, kv.pools) is kv.pools
    assert kv.rollback(0, 7) == 2            # keeps positions 0..6
    assert (kv.table[0, :2] == kept).all() and not kv.table[0, 2:].any()
    assert kv.blocks_in_use == 3 and kv.rollback_blocks_freed == 2
    assert 0 not in kv._prepared             # the whole intent was cut
    assert kv.rollback(0, 8) == 0            # within the last kept block
    assert kv.rollback(0, 0) == 2 and not kv.table[0].any()
    assert kv.describe()["rollback_blocks_freed"] == 4
    kv.ensure(0, 15)                          # freed blocks are reusable
    assert kv.blocks_in_use == 5
