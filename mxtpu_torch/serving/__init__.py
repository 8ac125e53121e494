"""Serving: continuous batching over a pool of device replicas, and
stateful decode (``serving.decode``)."""
from .admission import (ACCEPTING, DEGRADED, SHEDDING, AdmissionPolicy,
                        AdmissionShed, AdmissionSignals, Decision,
                        DecodeAdmissionPolicy, SignalAdmissionPolicy,
                        derive_knobs, mix_service_model)
from .batcher import (BatcherClosed, ContinuousBatcher, DynamicBatcher,
                      QueueFull, WorkItem, pad_rows, pick_bucket)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .pool import (ExecutorPool, WarmExecutableCache, default_contexts,
                   params_token, prewarm, symbol_json_hash, warm_cache)
from .server import (DEFAULT_BUCKETS, ReplicaCrash, ServingHTTPServer,
                     ServingSession, serve)
from .decode import (DecodeResult, DecodeSession, DecodeWorkerCrash,
                     PagedArena, SequenceSlotArena, TokenStream,
                     serve_decode)

__all__ = [
    "ACCEPTING", "DEGRADED", "SHEDDING", "AdmissionPolicy", "AdmissionShed",
    "AdmissionSignals", "Decision", "DecodeAdmissionPolicy",
    "SignalAdmissionPolicy", "derive_knobs", "mix_service_model",
    "BatcherClosed", "ContinuousBatcher", "DynamicBatcher", "QueueFull",
    "WorkItem", "pad_rows", "pick_bucket",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "ExecutorPool", "WarmExecutableCache", "default_contexts", "prewarm",
    "warm_cache", "params_token", "symbol_json_hash",
    "DEFAULT_BUCKETS", "ReplicaCrash", "ServingHTTPServer",
    "ServingSession", "serve",
    "DecodeSession", "DecodeResult", "DecodeWorkerCrash",
    "PagedArena", "SequenceSlotArena", "TokenStream", "serve_decode",
]
