from .engine import PagedLM, Request, ServeEngine
from .kvcache import PagedCacheConfig, PagedKVCache

__all__ = ["PagedLM", "Request", "ServeEngine", "PagedCacheConfig",
           "PagedKVCache"]
