"""repro_torch.serve — the dependable serving engine (docs/serving.md).

Continuous-batching inference over a block-paged KV cache
(``PagedKVCache``: shared page pool, per-request page tables, refcounted
prefix sharing) for attention stacks, or the slot pool (``CachePool``:
one contiguous row a request; Mamba stacks' only pool), N model replicas
registered with the heartbeat monitor, and detect-and-recover failover:
a dead or sentinel-flagged replica's requests drain back to the queue
and re-execute on survivors with token-identical greedy streams; warm
standbys restored through ``CheckpointManager`` restore capacity.
"""
from repro_torch.serve.cache_pool import CachePool, PoolExhausted
from repro_torch.serve.engine import ServeEngine, pctl
from repro_torch.serve.page_table import (DEFAULT_PAGE_SIZE, AdmitPlan,
                                          PagedKVCache, PageExhausted,
                                          PrefixEntry)
from repro_torch.serve.replica import (Replica, ServeFns,
                                       make_standby_source,
                                       restore_standby_params)
from repro_torch.serve.router import NoHealthyReplicasError, ReplicaRouter
from repro_torch.serve.scheduler import (DECODE, DONE, FAILED, PREFILL,
                                         QUEUED, QueueFull, Request,
                                         Scheduler)

__all__ = [
    "ServeEngine", "pctl", "Scheduler", "Request", "QueueFull",
    "CachePool", "PoolExhausted",
    "PagedKVCache", "PageExhausted", "AdmitPlan", "PrefixEntry",
    "DEFAULT_PAGE_SIZE", "Replica", "ServeFns", "ReplicaRouter",
    "NoHealthyReplicasError", "make_standby_source",
    "restore_standby_params",
    "QUEUED", "PREFILL", "DECODE", "DONE", "FAILED",
]
