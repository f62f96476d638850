"""Paged KV cache: fixed-size blocks + per-slot block tables
(``repro.serving.kv_cache``), without prefix sharing.

Global-attention layers share a pool of ``num_blocks`` fixed-size blocks
on the model's device; each slot holds a host-side block table mapping
its logical positions to physical blocks.  Physical block 0 is the
reserved *trash* block: unmapped table entries point at it, so idle
slots' decode writes land there harmlessly.  Block allocation goes
through the ``core/memory`` managers, whose ``OutOfMemory`` is the
engine's preemption trigger.  Speculative decoding declares its writes
(``begin_write`` / ``prepare_write``) and truncates rejected spans
(``rollback``); with no prefix sharing every block has one owner, so no
write needs a copy-on-write.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.memory.manager import (BumpMemoryManager,
                                             CachingMemoryManager,
                                             MemoryManagerAdapter,
                                             OutOfMemory)
from repro_torch.runtime.device import host_to_device

__all__ = ["BlockTable", "PagedKVCache", "OutOfMemory", "paged_block_bytes"]


@dataclass
class BlockTable:
    """Device view of the block tables: ``table`` int32
    ``[slots, max_blocks]`` physical block ids (0 = trash block)."""

    table: torch.Tensor
    block_size: int


def paged_block_bytes(cfg, block_size: int) -> int:
    """Bytes one block occupies across every paged layer (the allocation
    unit handed to the memory manager)."""
    item = torch.empty((), dtype=cfg.resolved_cache_dtype).element_size()
    per_pos = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * item   # k + v
    return max(1, cfg.n_layers * per_pos * block_size)


class PagedKVCache:
    """Host-side block tables + pool manager for one ``ServeEngine``.

    ``self.pools`` is the model's paged cache (per stage ``{"k", "v"}``
    of ``[layers, num_blocks * block_size, Kv, D]``, on the model's
    device); decode and prefill update it in place.
    """

    def __init__(self, model, *, slots: int, max_seq: int, block_size: int,
                 num_blocks: int | None = None,
                 manager: MemoryManagerAdapter | str | None = None,
                 prefix=None):
        if prefix is not None:
            raise NotImplementedError("prefix sharing is not ported")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.max_blocks = math.ceil(max_seq / block_size)
        if num_blocks is None:
            # roomy default: every slot can reach max_seq (+ trash block)
            num_blocks = slots * self.max_blocks + 1
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_bytes = paged_block_bytes(model.cfg, block_size)
        if manager is None or isinstance(manager, str):
            make = {None: CachingMemoryManager,
                    "caching": CachingMemoryManager,
                    "bump": BumpMemoryManager}[manager]
            kw = {} if make is BumpMemoryManager else \
                {"round_to": self.block_bytes}
            manager = make(capacity=num_blocks * self.block_bytes, **kw)
        self.manager = manager
        self.pools = model.init_paged_cache(slots, max_seq,
                                            num_blocks=num_blocks,
                                            block_size=block_size)
        self.table = np.zeros((slots, self.max_blocks), np.int32)
        self._blocks: dict[int, list[int]] = {}     # slot -> [block id]
        # speculative bookkeeping, as in the reference: the most recent
        # declared write range per slot and the positions whose KV is
        # final (the reference's KV audit reads both; it is not ported)
        self._prepared: dict[int, tuple[int, int]] = {}
        self._committed: dict[int, int] = {}
        self.rollback_blocks_freed = 0
        # reserve physical block 0 as the trash block, never freed
        ptr0 = self.manager.alloc(self.block_bytes)
        if ptr0 // self.block_bytes != 0:
            raise ValueError(
                "paged KV cache needs a fresh block-aligned arena; got "
                f"first offset {ptr0}")

    # -- capacity ------------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1          # minus the trash block

    @property
    def blocks_in_use(self) -> int:
        return sum(len(v) for v in self._blocks.values())

    def blocks_for(self, pos: int) -> int:
        """Blocks a slot needs so position ``pos`` is writable."""
        return pos // self.block_size + 1

    # -- slot lifecycle ------------------------------------------------------
    def ensure(self, slot: int, pos: int) -> None:
        """Map enough blocks that ``pos`` is writable for ``slot``; raises
        :class:`OutOfMemory` when the allocator cannot grow it."""
        need = self.blocks_for(pos)
        if need > self.max_blocks:
            raise OutOfMemory(
                f"position {pos} exceeds max_seq={self.max_seq} "
                f"({self.max_blocks} blocks/slot)")
        held = self._blocks.setdefault(slot, [])
        while len(held) < need:
            bid = self.manager.alloc(self.block_bytes) // self.block_bytes
            self.table[slot, len(held)] = bid
            held.append(bid)

    def release(self, slot: int) -> None:
        """Return every block a slot holds (finished or evicted)."""
        for bid in self._blocks.pop(slot, []):
            self.manager.unlock(bid * self.block_bytes)
        self.table[slot] = 0
        self._prepared.pop(slot, None)
        self._committed.pop(slot, None)

    # -- speculative writes and rollback -------------------------------------
    def set_committed(self, slot: int, n: int) -> None:
        """Positions ``[0, n)`` of ``slot`` hold final KV content."""
        self._committed[slot] = n

    def begin_write(self, slot: int, lo: int, hi: int) -> None:
        """Declare an upcoming write to positions ``[lo, hi]`` before the
        mapping grows to cover it."""
        self._prepared[slot] = (lo, hi)

    def prepare_write(self, slot: int, lo: int, hi: int, pools):
        """The write barrier for positions ``[lo, hi]``: records the
        intent and returns ``pools`` unchanged.  The reference copies a
        block other sharers hold before a divergent write lands; without
        prefix sharing no block has a second owner."""
        self._prepared[slot] = (lo, hi)
        return pools

    def rollback(self, slot: int, new_len: int) -> int:
        """Truncate ``slot`` to ``new_len`` committed positions: blocks
        past the one holding position ``new_len - 1`` go back to the
        memory manager and their table columns to the trash block 0.
        Positions inside the last kept block need no cleanup: validity
        hides them and later writes overwrite them.  Returns the number
        of blocks freed."""
        held = self._blocks.get(slot, [])
        keep = 0 if new_len <= 0 else (new_len - 1) // self.block_size + 1
        freed = 0
        while len(held) > keep:
            bid = held.pop()
            self.table[slot, len(held)] = 0
            self.manager.unlock(bid * self.block_bytes)
            freed += 1
        self._committed[slot] = new_len
        if slot in self._prepared:
            lo, hi = self._prepared[slot]
            if lo >= new_len:
                del self._prepared[slot]
            elif hi >= new_len:
                self._prepared[slot] = (lo, new_len - 1)
        self.rollback_blocks_freed += freed
        return freed

    # -- device views --------------------------------------------------------
    def device_table(self) -> BlockTable:
        return BlockTable(host_to_device(self.table, self.model.device),
                          self.block_size)

    def describe(self) -> dict:
        s = self.manager.stats
        return {"block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "max_blocks_per_slot": self.max_blocks,
                "block_bytes": self.block_bytes,
                "blocks_in_use": self.blocks_in_use,
                "manager": type(self.manager).__name__,
                "device_allocs": s.n_device_allocs,
                "internal_fragmentation": s.internal_fragmentation,
                "rollback_blocks_freed": self.rollback_blocks_freed}
