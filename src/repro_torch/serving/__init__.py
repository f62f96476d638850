from .engine import Request, ServeEngine
from .kv_cache import BlockTable, OutOfMemory, PagedKVCache
from .scheduler import make_scheduler
from .speculative import (FixedProposer, NGramProposer, Proposer,
                          make_proposer)

__all__ = ["Request", "ServeEngine", "BlockTable", "OutOfMemory",
           "PagedKVCache", "make_scheduler", "Proposer", "NGramProposer",
           "FixedProposer", "make_proposer"]
