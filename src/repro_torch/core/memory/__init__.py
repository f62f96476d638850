from .manager import (BumpMemoryManager, CachingMemoryManager,
                      MemoryManagerAdapter, MemoryStats, OutOfMemory)

__all__ = ["BumpMemoryManager", "CachingMemoryManager",
           "MemoryManagerAdapter", "MemoryStats", "OutOfMemory"]
