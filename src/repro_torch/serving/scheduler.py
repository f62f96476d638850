"""Pluggable serving schedulers: who is admitted next, who is evicted.

Copied from ``repro.serving.scheduler`` (framework-free).  The engine
calls ``submit`` when a request arrives, ``pop`` when a cache slot frees
up, ``requeue`` when a request is preempted or could not be admitted,
and ``choose_victim`` when an active slot must be evicted to reclaim KV
blocks.  All built-ins break ties by arrival order, so traces are
deterministic.
"""

from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover
    from .engine import Request


@runtime_checkable
class Scheduler(Protocol):
    """Admission/preemption policy consumed by ``ServeEngine``."""

    name: str

    def submit(self, req: "Request") -> None:
        """A new request arrived."""

    def pop(self) -> "Request | None":
        """Next request to admit (None = queue empty)."""

    def requeue(self, req: "Request") -> None:
        """A preempted / unadmittable request returns to the queue."""

    def __len__(self) -> int:
        """Requests currently waiting."""

    def choose_victim(self, active: "dict[int, Request]") -> int:
        """Slot to evict when the block pool runs dry (``active`` maps
        slot -> request and is never empty here)."""


class FifoScheduler:
    """First-come-first-served; preempted requests return to the front
    (they arrived earliest among equals).  Victim: youngest admission —
    it has the least decode progress to throw away."""

    name = "fifo"

    def __init__(self):
        self._q: deque = deque()

    def submit(self, req) -> None:
        self._q.append(req)

    def pop(self):
        return self._q.popleft() if self._q else None

    def requeue(self, req) -> None:
        self._q.appendleft(req)

    def __len__(self) -> int:
        return len(self._q)

    def choose_victim(self, active) -> int:
        return max(active, key=lambda s: active[s].admit_seq)


class _HeapScheduler:
    """Shared heap machinery; subclasses define ``_key(req)``."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def _key(self, req):  # pragma: no cover - abstract
        raise NotImplementedError

    def submit(self, req) -> None:
        heapq.heappush(self._heap, (self._key(req), next(self._seq), req))

    def pop(self):
        return heapq.heappop(self._heap)[2] if self._heap else None

    # the key is recomputed, so a preempted request re-sorts with its
    # grown effective prompt (prompt + tokens generated so far)
    requeue = submit

    def __len__(self) -> int:
        return len(self._heap)

    def choose_victim(self, active) -> int:
        return max(active, key=lambda s: active[s].admit_seq)


class ShortestPromptScheduler(_HeapScheduler):
    """Shortest-prompt-first: minimizes mean time-to-first-token under
    mixed-length traffic (classic SJF, prompt length as the job size)."""

    name = "sjf"

    def _key(self, req):
        return len(req.prompt) + len(req.generated)


class PriorityScheduler(_HeapScheduler):
    """Priority/deadline admission: higher ``Request.priority`` first,
    earlier ``deadline`` breaks priority ties.  Victim: the least
    important active request (lowest priority, then latest deadline,
    then youngest admission)."""

    name = "priority"

    def _key(self, req):
        deadline = req.deadline if req.deadline is not None else math.inf
        return (-req.priority, deadline)

    def choose_victim(self, active) -> int:
        def badness(slot):
            r = active[slot]
            deadline = r.deadline if r.deadline is not None else math.inf
            return (-r.priority, deadline, r.admit_seq)

        return max(active, key=badness)


_REGISTRY = {cls.name: cls for cls in
             (FifoScheduler, ShortestPromptScheduler, PriorityScheduler)}
_REGISTRY["shortest"] = ShortestPromptScheduler
_REGISTRY["deadline"] = PriorityScheduler


def make_scheduler(spec) -> Scheduler:
    """Resolve a ``ServingPolicy.scheduler`` spec: a registry name, a
    Scheduler instance (passed through), or a Scheduler class."""
    if isinstance(spec, str):
        try:
            return _REGISTRY[spec]()
        except KeyError:
            raise ValueError(f"unknown scheduler {spec!r}; "
                             f"known: {sorted(_REGISTRY)}") from None
    if isinstance(spec, type):
        return spec()
    return spec
