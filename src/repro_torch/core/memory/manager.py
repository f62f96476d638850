"""Memory-management interface (paper §4.1.2, Listing 3), copied from
``repro.core.memory.manager``.

The arena model: a manager controls a contiguous arena of ``capacity``
bytes.  ``alloc`` returns an offset; ``unlock`` returns the block.  The
paged KV cache (``repro_torch/serving/kv_cache.py``) hands out its pool
blocks through these managers, so allocator policies (caching vs bump)
drive admission and preemption.  The reference's allocation telemetry is
not ported.
"""

from __future__ import annotations

import abc
import bisect
from dataclasses import dataclass


class OutOfMemory(RuntimeError):
    pass


@dataclass
class Block:
    offset: int
    size: int            # allocated (rounded) size
    requested: int = 0   # user-requested size
    free: bool = True


@dataclass
class MemoryStats:
    capacity: int = 0
    live_requested: int = 0      # bytes the user asked for, currently live
    live_allocated: int = 0      # bytes actually reserved for live blocks
    peak_requested: int = 0
    peak_allocated: int = 0
    high_water: int = 0          # arena high-water mark (external frag proxy)
    n_allocs: int = 0
    n_frees: int = 0
    n_device_allocs: int = 0     # cache misses -> "cudaMalloc"-equivalents
    n_splits: int = 0

    @property
    def internal_fragmentation(self) -> float:
        """Wasted bytes inside live blocks / live allocated bytes."""
        if self.peak_allocated == 0:
            return 0.0
        return 1.0 - self.peak_requested / self.peak_allocated

    @property
    def external_fragmentation(self) -> float:
        """Arena footprint beyond what live data needed at the peak."""
        if self.high_water == 0:
            return 0.0
        return 1.0 - self.peak_allocated / self.high_water


class MemoryManagerAdapter(abc.ABC):
    """The open allocator API (paper Listing 3: ``alloc``/``unlock``)."""

    def __init__(self, capacity: int = 1 << 34):
        self.capacity = capacity
        self.stats = MemoryStats(capacity=capacity)

    @abc.abstractmethod
    def alloc(self, size: int, user_lock: bool = False) -> int:
        """Reserve ``size`` bytes; returns the arena offset."""

    @abc.abstractmethod
    def unlock(self, ptr: int, user_lock: bool = False) -> None:
        """Release the block at ``ptr`` (paper's ``unlock`` == free)."""

    def _on_alloc(self, requested: int, allocated: int, offset: int) -> None:
        s = self.stats
        s.n_allocs += 1
        s.live_requested += requested
        s.live_allocated += allocated
        s.peak_requested = max(s.peak_requested, s.live_requested)
        s.peak_allocated = max(s.peak_allocated, s.live_allocated)
        s.high_water = max(s.high_water, offset + allocated)

    def _on_free(self, requested: int, allocated: int) -> None:
        s = self.stats
        s.n_frees += 1
        s.live_requested -= requested
        s.live_allocated -= allocated


class BumpMemoryManager(MemoryManagerAdapter):
    """Trivial bump allocator: never reuses memory. Lower bound baseline."""

    def __init__(self, capacity: int = 1 << 34):
        super().__init__(capacity)
        self._cursor = 0
        self._blocks: dict[int, Block] = {}

    def alloc(self, size: int, user_lock: bool = False) -> int:
        if self._cursor + size > self.capacity:
            raise OutOfMemory(f"bump allocator exhausted at {self._cursor}")
        off = self._cursor
        self._cursor += size
        self._blocks[off] = Block(off, size, size, free=False)
        self.stats.n_device_allocs += 1
        self._on_alloc(size, size, off)
        return off

    def unlock(self, ptr: int, user_lock: bool = False) -> None:
        b = self._blocks.pop(ptr)
        self._on_free(b.requested, b.size)


class CachingMemoryManager(MemoryManagerAdapter):
    """Bucketed caching allocator with optional split-threshold policy.

    Reproduces the §5.2.2 case study: a caching allocator that buckets
    allocations by rounded size is subject to fragmentation; *restricting
    splitting of large cached blocks* (blocks beyond ``split_threshold``)
    reduced internal fragmentation "for most models by over 20%".

    Parameters
    ----------
    round_to: bucket granularity (rounded up to a multiple of this).
    split_large_blocks: if True, a cached block much larger than the request
        may be split; if False (or above threshold), it is handed out whole,
        inflating internal fragmentation.
    split_threshold: blocks larger than this are never split when
        ``restrict_large_splits`` policy is active.
    """

    def __init__(self, capacity: int = 1 << 34, round_to: int = 512,
                 split_large_blocks: bool = True,
                 split_threshold: int | None = None,
                 min_split_remainder: int = 512):
        super().__init__(capacity)
        self.round_to = round_to
        self.split_large_blocks = split_large_blocks
        self.split_threshold = split_threshold
        self.min_split_remainder = min_split_remainder
        self._cursor = 0
        self._live: dict[int, Block] = {}
        # free list sorted by size for best-fit
        self._free_sizes: list[int] = []
        self._free_blocks: list[Block] = []

    def _round(self, size: int) -> int:
        r = self.round_to
        return (size + r - 1) // r * r

    def _insert_free(self, block: Block) -> None:
        block.free = True
        i = bisect.bisect_left(self._free_sizes, block.size)
        self._free_sizes.insert(i, block.size)
        self._free_blocks.insert(i, block)

    def _pop_best_fit(self, size: int) -> Block | None:
        i = bisect.bisect_left(self._free_sizes, size)
        if i == len(self._free_sizes):
            return None
        self._free_sizes.pop(i)
        return self._free_blocks.pop(i)

    def alloc(self, size: int, user_lock: bool = False) -> int:
        rounded = self._round(size)
        block = self._pop_best_fit(rounded)
        if block is None:
            # cache miss: carve new memory from the arena ("cudaMalloc")
            if self._cursor + rounded > self.capacity:
                raise OutOfMemory(
                    f"arena exhausted: cursor={self._cursor} req={rounded}")
            block = Block(self._cursor, rounded)
            self._cursor += rounded
            self.stats.n_device_allocs += 1
        elif block.size > rounded:
            may_split = self.split_large_blocks and (
                self.split_threshold is None
                or block.size <= self.split_threshold)
            remainder = block.size - rounded
            if may_split and remainder >= self.min_split_remainder:
                tail = Block(block.offset + rounded, remainder)
                self._insert_free(tail)
                block = Block(block.offset, rounded)
                self.stats.n_splits += 1
            # else: hand out the whole cached block (internal fragmentation)
        block.free = False
        block.requested = size
        self._live[block.offset] = block
        self._on_alloc(size, block.size, block.offset)
        return block.offset

    def unlock(self, ptr: int, user_lock: bool = False) -> None:
        block = self._live.pop(ptr)
        self._on_free(block.requested, block.size)
        block.requested = 0
        self._insert_free(block)
