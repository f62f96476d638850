"""Batched serving engine (``repro.serving.engine``): continuous batching
over a static slot pool on the paged KV cache.

Requests join a pluggable scheduler; free slots are assigned in
ascending order each step.  Admission runs chunked batched prefill (one
``prefill_step`` per chunk for every newly admitted slot at once), then
every active slot advances one token per ``decode_step`` at its own
position.  When the block pool runs dry the scheduler picks a victim:
its blocks are freed and the request is requeued, recomputed on
re-admission.  Greedy argmax runs on the device; each decode step makes
one host sync, to read the new tokens.

With ``ServingPolicy.speculative`` on (and a model whose
``supports_speculative()`` is true) each step is one draft-propose /
wide-verify / rollback round instead (``_spec_step``): a proposer
guesses up to k tokens per slot, one ``verify_step`` scores them all,
the longest prefix matching the greedy targets is accepted plus one
bonus token, and the rejected suffix's blocks are freed.  The output is
token-for-token that of one-token decode.

Not ported yet: the dense cache, prefix sharing, draft-model proposals,
beam forks, observability, and the KV audit after releases
(``_audit_kv``, which needs the analysis package: ROADMAP.md queue 1
item 8).  Models whose layers carry SSM recurrent state, and MLA models,
are refused as in the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.runtime.device import host_to_device
from repro_torch.runtime.policies import ServingPolicy
from repro_torch.runtime.stack import current_session

from .kv_cache import OutOfMemory, PagedKVCache
from .scheduler import make_scheduler
from .speculative import make_proposer


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    priority: int = 0                 # higher = more important (scheduler)
    deadline: float | None = None     # smaller = more urgent (scheduler)
    generated: list[int] = field(default_factory=list)
    done: bool = False
    # engine bookkeeping (time.perf_counter timestamps)
    submit_time: float = 0.0
    first_token_time: float | None = None
    token_times: list[float] = field(default_factory=list)
    admit_seq: int = -1               # admission order (victim selection)
    preemptions: int = 0


class ServeEngine:
    def __init__(self, model, params, *, batch_slots: int, max_seq: int,
                 policy: ServingPolicy | None = None, proposer=None):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        # without a policy the engine serves the session's scenario, as
        # the reference's does
        sess = current_session()
        self.policy = policy if policy is not None else sess.serving
        if sess.kernels.decode_attention is not None:
            raise NotImplementedError(
                "session(kernels={'decode_attention': fn}): the override "
                "takes the reference's dense-cache view; the port decodes "
                "from the paged cache with its paged_decode kernel (dense "
                "cache: ROADMAP queue 1 item 2)")
        self.device = model.device

        # SSM-family caches are recurrent state, not position-addressed:
        # staggered admission would corrupt other sequences (see
        # _admit); only one pristine-slot admission at a time is safe.
        self._recurrent = getattr(model, "has_recurrent_state",
                                  lambda: False)()
        self._slots_used: set[int] = set()

        if self.policy.cache != "paged":
            raise NotImplementedError(
                f"cache layout {self.policy.cache!r}: only the paged KV "
                "cache is ported")
        if not getattr(model, "supports_paged_cache", lambda: False)():
            raise ValueError(
                "this model does not support the paged KV cache (MLA "
                "latent caches are dense-only for now)")
        if self.policy.prefix.enabled:
            raise NotImplementedError("prefix sharing is not ported")
        if self.policy.prefill_chunk <= 0 or not getattr(
                model, "supports_chunked_prefill", lambda: False)():
            raise NotImplementedError(
                "only chunked prefill (prefill_chunk > 0) is ported")
        self.kv = PagedKVCache(model, slots=batch_slots, max_seq=max_seq,
                               block_size=self.policy.block_size,
                               num_blocks=self.policy.num_blocks,
                               manager=self.policy.allocator)
        self.cache = self.kv.pools
        # speculation needs a model whose caches all roll back by
        # block-table truncation; otherwise it degrades to plain decode
        self.spec_on = (self.policy.speculative.enabled and getattr(
            model, "supports_speculative", lambda: False)())
        self.proposer = None
        if self.spec_on:
            self.proposer = (proposer if proposer is not None
                             else make_proposer(self.policy.speculative))
        self.scheduler = make_scheduler(self.policy.scheduler)
        self.active: dict[int, Request] = {}     # slot -> request
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.slot_tok = np.zeros((batch_slots, 1), np.int32)
        self.steps = 0
        self.decode_calls = 0
        self.prefill_calls = 0
        self.preemptions = 0
        self._admit_counter = 0
        self.spec_rounds = 0
        self.slot_rounds = 0     # (slot, round) verify instances
        self.verify_calls = 0
        self.accepted_tokens = 0
        self.rejected_tokens = 0

    # -- device steps --------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return host_to_device(a, self.device)

    def _decode(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._to_device(tok),
            self._to_device(pos), block_table=self.kv.device_table())
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _verify(self, toks: np.ndarray, start: np.ndarray,
                count: np.ndarray) -> torch.Tensor:
        """Wide verify: greedy targets ``[B, T]`` for every position."""
        logits, self.cache = self.model.verify_step(
            self.params, self.cache, self._to_device(toks),
            self._to_device(start), self._to_device(count),
            block_table=self.kv.device_table())
        return torch.argmax(logits, dim=-1).to(torch.int32)

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submit_time = time.perf_counter()
        self.scheduler.submit(req)

    def _admit(self) -> list[tuple[int, Request, list[int]]]:
        free = sorted(s for s in range(self.slots) if s not in self.active)
        admitted: list[tuple[int, Request, list[int]]] = []
        while free:
            req = self.scheduler.pop()
            if req is None:
                break
            slot = free.pop(0)                      # ascending: determinism
            if self._recurrent and (self.active or slot in self._slots_used):
                raise ValueError(
                    "SSM-family models carry recurrent state: admitting "
                    f"request {req.uid} mid-flight or into a recycled slot "
                    "would silently corrupt decoding")
            self._slots_used.add(slot)
            # a preempted request resumes from prompt + tokens so far
            eff = req.prompt + req.generated
            if len(eff) - 1 >= self.max_seq:
                raise ValueError(
                    f"request {req.uid} prompt ({len(eff)} tokens) does "
                    f"not fit max_seq={self.max_seq}; requeueing would "
                    "spin forever")
            if self.kv.blocks_for(len(eff) - 1) > self.kv.usable_blocks:
                raise OutOfMemory(
                    f"request {req.uid} needs more KV blocks than the "
                    f"whole pool holds ({self.kv.usable_blocks} usable "
                    f"blocks of {self.kv.block_size} positions)")
            try:
                self.kv.ensure(slot, len(eff) - 1)
            except OutOfMemory:
                # pool dry: roll back the partial allocation and wait for
                # active slots to finish (or get evicted later)
                self.kv.release(slot)
                self.scheduler.requeue(req)
                break
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.active[slot] = req
            self.slot_pos[slot] = len(eff) - 1
            self.slot_tok[slot, 0] = eff[-1]
            admitted.append((slot, req, eff))
        if admitted:
            self._prefill_chunked(admitted)
        return admitted

    def _prefill_chunked(self, admitted) -> None:
        """All newly admitted slots prefill together, one call per chunk:
        ceil(longest prompt / chunk) calls per admission round.  The last
        prompt token is fed by the first decode step."""
        t = self.policy.prefill_chunk
        longest = max(len(eff) - 1 for _s, _r, eff in admitted)
        bt = self.kv.device_table()
        for c in range(0, longest, t):
            toks = np.zeros((self.slots, t), np.int32)
            start = np.zeros(self.slots, np.int32)
            count = np.zeros(self.slots, np.int32)
            for slot, _req, eff in admitted:
                seg = eff[:-1][c:c + t]
                if not seg:
                    continue
                toks[slot, :len(seg)] = seg
                start[slot] = c
                count[slot] = len(seg)
            self.cache = self.model.prefill_step(
                self.params, self.cache, self._to_device(toks),
                self._to_device(start), self._to_device(count),
                block_table=bt)
            self.prefill_calls += 1

    # -- preemption ----------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        req = self.active.pop(slot)
        req.preemptions += 1
        self.preemptions += 1
        self.kv.release(slot)
        if self.spec_on:
            self.proposer.release(slot)
        self.scheduler.requeue(req)

    def _ensure_capacity(self, widths: dict[int, int] | None = None) -> None:
        """Every active slot must be able to write its next position, or
        in a speculative round its ``widths[slot]`` positions from there
        (declared as a write intent before the growth); when the pool
        runs dry, evict scheduler-chosen victims (their blocks free, the
        requests requeue and recompute later)."""
        for slot in sorted(self.active):
            while slot in self.active:
                lo = int(self.slot_pos[slot])
                hi = lo if widths is None else lo + widths[slot] - 1
                try:
                    if widths is not None:
                        self.kv.begin_write(slot, lo, hi)
                    self.kv.ensure(slot, hi)
                    if widths is not None:
                        self.cache = self.kv.prepare_write(slot, lo, hi,
                                                           self.cache)
                    break
                except OutOfMemory:
                    others = {s: r for s, r in self.active.items()
                              if s != slot}
                    if not others:
                        # this request alone exhausts the pool
                        self._preempt(slot)
                        raise
                    self._preempt(self.scheduler.choose_victim(others))

    # -- stepping -------------------------------------------------------------
    def step(self) -> list[Request]:
        """Admit, then advance every active slot: one token in plain
        mode, 1..k+1 tokens per slot in one speculative round; returns
        the requests that finished."""
        if self.spec_on:
            return self._spec_step()
        return self._plain_step()

    def _plain_step(self) -> list[Request]:
        self._admit()
        if not self.active:
            return []
        self._ensure_capacity()
        if not self.active:
            return []
        next_tok = self._decode(self.slot_tok, self.slot_pos)
        self.decode_calls += 1
        next_np = next_tok.cpu().numpy()                 # the one host sync
        now = time.perf_counter()
        finished = []
        for slot, req in list(self.active.items()):
            t = int(next_np[slot])
            self._emit_token(req, t, now)
            self.slot_tok[slot, 0] = t
            self.slot_pos[slot] += 1
            if ((req.eos_id is not None and t == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens
                    or self.slot_pos[slot] >= self.max_seq - 1):
                req.done = True
                finished.append(req)
                del self.active[slot]
                self.kv.release(slot)
        self.steps += 1
        return finished

    def _spec_step(self) -> list[Request]:
        """One draft-propose / wide-verify / rollback round.

        A slot whose last emitted token ``t`` sits at position ``p``, with
        proposals ``d_1..d_{c-1}``, feeds ``[t, d_1..d_{c-1}]`` at
        positions ``p..p+c-1`` (one batched forward, per-slot width via
        ``count``) and gets greedy targets ``g_0..g_{c-1}``.  The accepted
        prefix is the longest ``a`` with ``d_{i+1} == g_i``; the slot
        emits ``d_1..d_a, g_a``, exactly what one-token greedy decode
        would have emitted.  The rejected suffix's blocks roll back."""
        for slot, _req, eff in self._admit():
            n = len(eff) - 1
            self.kv.set_committed(slot, n)
            if slot not in self.kv._prepared:
                self.kv.begin_write(slot, max(n - 1, 0), max(n - 1, 0))
            self.proposer.admit(slot, eff)
        if not self.active:
            return []
        k = self.policy.speculative.k
        width = k + 1
        proposals = self.proposer.propose(
            {s: r.prompt + r.generated for s, r in self.active.items()}, k)
        counts: dict[int, tuple[int, list[int]]] = {}
        for s in list(self.active):
            props = [int(t) for t in proposals.get(s, [])][:k]
            # verify writes positions p..p+c-1; clamp inside the cache
            c = min(len(props) + 1, width,
                    self.max_seq - int(self.slot_pos[s]))
            counts[s] = (c, props[:c - 1])
        self._ensure_capacity({s: c for s, (c, _p) in counts.items()})
        if not self.active:
            return []
        toks = np.zeros((self.slots, width), np.int32)
        start = np.zeros(self.slots, np.int32)
        count = np.zeros(self.slots, np.int32)
        for s in self.active:
            c, props = counts[s]
            toks[s, :c] = ([int(self.slot_tok[s, 0])] + props)[:c]
            start[s] = self.slot_pos[s]
            count[s] = c
        greedy = self._verify(toks, start, count)
        self.verify_calls += 1
        g = greedy.cpu().numpy()                         # the one host sync
        self.spec_rounds += 1
        self.slot_rounds += len(self.active)
        now = time.perf_counter()
        finished = []
        accepted: dict[int, int] = {}
        for slot, req in list(self.active.items()):
            props = counts[slot][1]
            a = 0
            while a < len(props) and props[a] == int(g[slot, a]):
                a += 1
            emit = props[:a] + [int(g[slot, a])]
            accepted[slot] = a
            self.accepted_tokens += a
            self.rejected_tokens += len(props) - a
            p0 = int(self.slot_pos[slot])
            done = False
            n_emit = 0
            for t in emit:
                self._emit_token(req, t, now)
                n_emit += 1
                if ((req.eos_id is not None and t == req.eos_id)
                        or len(req.generated) >= req.max_new_tokens
                        or p0 + n_emit >= self.max_seq - 1):
                    done = True
                    break
            self.slot_pos[slot] = p0 + n_emit
            self.slot_tok[slot, 0] = emit[n_emit - 1]
            # KV past the new position is the unwritten bonus token or
            # rejected content: truncate it
            self.kv.rollback(slot, p0 + n_emit)
            if done:
                req.done = True
                finished.append(req)
                del self.active[slot]
                self.kv.release(slot)
                self.proposer.release(slot)
        self.proposer.commit(accepted)
        self.steps += 1
        return finished

    @staticmethod
    def _emit_token(req: Request, t: int, now: float) -> None:
        req.generated.append(t)
        req.token_times.append(now)
        if req.first_token_time is None:
            req.first_token_time = now

    def run_until_done(self, max_steps: int = 10000) -> list[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not len(self.scheduler):
                break
        return out

    # -- provenance ----------------------------------------------------------
    def describe(self) -> dict:
        """Serving-scenario snapshot for logs."""
        return {"policy": self.policy.describe(),
                "device": str(self.device),
                "slots": self.slots, "max_seq": self.max_seq,
                "decode_calls": self.decode_calls,
                "prefill_calls": self.prefill_calls,
                "preemptions": self.preemptions,
                "speculative": self._describe_speculative(),
                "kv_cache": self.kv.describe()}

    def _describe_speculative(self) -> dict:
        spec = {"enabled": self.spec_on,
                "rounds": self.spec_rounds,
                "slot_rounds": self.slot_rounds,
                "verify_calls": self.verify_calls,
                "accepted_tokens": self.accepted_tokens,
                "rejected_tokens": self.rejected_tokens,
                # mean tokens a slot emits per verify round, in [1, k + 1]
                "accepted_per_step": round(
                    (self.accepted_tokens + self.slot_rounds)
                    / max(1, self.slot_rounds), 3)}
        if self.proposer is not None:
            spec["proposer"] = self.proposer.describe()
        return spec
