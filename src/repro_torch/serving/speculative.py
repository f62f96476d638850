"""Draft proposers for speculative decoding on the paged KV cache
(``repro.serving.speculative``).

The engine's speculative loop (``ServeEngine._spec_step``) is
draft-propose / wide-verify / rollback: a proposer guesses up to ``k``
next tokens per active slot; the target model scores the last accepted
token plus all proposals in one batched wide forward
(``LM.verify_step``, which runs the paged flash-verify kernel); the
longest proposal prefix matching the target's own greedy argmax is
accepted, one bonus token comes free from the verify logits, and the
rejected suffix rolls back by truncating the slot's block table
(``PagedKVCache.rollback``).  The acceptance rule makes greedy
speculative decoding token-for-token identical to one-token decode
whatever the proposals; proposers change only the tokens per verify call.

``NGramProposer`` (self-drafting from earlier occurrences of the
current suffix) and ``FixedProposer`` (proposals from a callable, the
tests' oracle and adversary) are ported.  ``ModelDraft`` needs a draft
model on a dense cache or with SSM state, which the port does not have
yet (ROADMAP.md, queue 1 item 1).  The reference's trace spans are left
out, as in the port's other modules.
"""

from __future__ import annotations


class Proposer:
    """Base proposer: stateless, proposes nothing (plain decode)."""

    def admit(self, slot: int, prompt: list[int]) -> None:
        """A request landed in ``slot`` with effective prompt ``prompt``
        (original prompt + tokens generated before a preemption)."""

    def release(self, slot: int) -> None:
        """The slot finished or was preempted; drop its state."""

    def propose(self, contexts: dict[int, list[int]],
                k: int) -> dict[int, list[int]]:
        """Per-slot draft continuations (0..k tokens each).
        ``contexts[slot]`` is the full token context, whose last element
        is the engine's ``slot_tok`` (emitted, KV not yet written)."""
        return {s: [] for s in contexts}

    def commit(self, accepted: dict[int, int]) -> None:
        """Verify outcome: ``accepted[slot]`` of the proposals were kept
        (plus the free bonus token)."""

    def describe(self) -> dict:
        return {"kind": type(self).__name__}


class NGramProposer(Proposer):
    """Suffix-matching self-drafter: finds the most recent earlier
    occurrence of the context's last ``n-1`` tokens (falling back to
    shorter suffixes down to 1) and proposes the tokens that followed."""

    def __init__(self, n: int = 3):
        self.n = max(2, int(n))

    def propose(self, contexts: dict[int, list[int]],
                k: int) -> dict[int, list[int]]:
        return {s: self._match(ctx, k) for s, ctx in contexts.items()}

    def _match(self, ctx: list[int], k: int) -> list[int]:
        size = len(ctx)
        for m in range(min(self.n - 1, size - 1), 0, -1):
            tail = ctx[size - m:]
            # latest candidate start leaving >= 1 follower token
            for i in range(size - m - 1, -1, -1):
                if ctx[i:i + m] == tail:
                    return ctx[i + m:i + m + k]
        return []

    def describe(self) -> dict:
        return {"kind": "NGramProposer", "n": self.n}


class FixedProposer(Proposer):
    """Proposals from a callable ``fn(context) -> list[int]``."""

    def __init__(self, fn):
        self.fn = fn

    def propose(self, contexts: dict[int, list[int]],
                k: int) -> dict[int, list[int]]:
        return {s: list(self.fn(ctx))[:k] for s, ctx in contexts.items()}


def make_proposer(spec) -> Proposer:
    """The proposer a ``SpeculativePolicy`` asks for."""
    if spec.draft == "model":
        raise NotImplementedError(
            "SpeculativePolicy(draft='model') is not ported: ModelDraft "
            "needs a draft model on the dense cache or with SSM state "
            "(ROADMAP.md, queue 1 item 1)")
    return NGramProposer(spec.ngram)
