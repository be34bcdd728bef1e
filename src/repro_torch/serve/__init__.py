from .engine import PagedLM, Request, ServeEngine
from .kvcache import PagedCacheConfig, PagedKVCache
from .kvpager import KVPager

__all__ = ["PagedLM", "Request", "ServeEngine", "PagedCacheConfig",
           "PagedKVCache", "KVPager"]
