from .engine import Request, ServeEngine
from .kv_cache import BlockTable, OutOfMemory, PagedKVCache
from .scheduler import make_scheduler

__all__ = ["Request", "ServeEngine", "BlockTable", "OutOfMemory",
           "PagedKVCache", "make_scheduler"]
