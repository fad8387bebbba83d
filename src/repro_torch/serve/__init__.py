"""Serving: ``ServeEngine`` (the single-batch ``generate`` path and
request-level ``serve``), the continuous-batching scheduler and the paged KV
cache it runs over."""
from .engine import ServeEngine
from .paged_cache import PageAllocator, PagedKVCache, PagesExhausted
from .scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ContinuousBatchingScheduler", "PageAllocator", "PagedKVCache", "PagesExhausted",
           "Request", "ServeEngine"]
