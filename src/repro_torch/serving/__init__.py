"""Paged serving runtime: continuous batching over paged, StruM-packed KV
caches (twin of ``repro.serving``)."""
from repro_torch.serving.pages import PageAllocator, PagesExhausted, cache_stats
from repro_torch.serving.scheduler import BatchScheduler, Request

__all__ = ["BatchScheduler", "Request", "PageAllocator", "PagesExhausted",
           "cache_stats"]
