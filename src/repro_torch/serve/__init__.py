from .engine import AsyncRequestLog, PagedLM, Request, ServeEngine
from .kvcache import PagedCacheConfig, PagedKVCache
from .kvpager import KVPager

__all__ = ["AsyncRequestLog", "PagedLM", "Request", "ServeEngine",
           "PagedCacheConfig", "PagedKVCache", "KVPager"]
