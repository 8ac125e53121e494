"""Serving: dynamic batching over a pool of device replicas."""
from .batcher import (BatcherClosed, DynamicBatcher, QueueFull, pad_rows,
                      pick_bucket)
from .metrics import MetricsRegistry
from .pool import ExecutorPool, default_contexts
from .server import ServingHTTPServer, ServingSession, serve

__all__ = ["BatcherClosed", "DynamicBatcher", "QueueFull", "pad_rows",
           "pick_bucket", "MetricsRegistry", "ExecutorPool",
           "default_contexts", "ServingHTTPServer", "ServingSession",
           "serve"]
