"""Batched FastTucker inference (``repro_torch.serve``) — Theorem 1 as a
server, counterpart of ``repro.serve``.

At inference the a-rows and B^(n) are both frozen, so the mode dots for
every row are cached once as per-mode Kruskal-product tables
``C^(n) = A^(n) B^(n) ∈ R^{I_n × R}``; any query is then a gather plus an
O(N·R) product-sum (the ``kruskal_contract`` kernel on the card), any mode
slice one factored einsum over the C^(n), and top-k recommendation a
(B, R)×(R, I) matmul.  The dense tensor is never materialized.

Layout:

    ``engine``      ``TuckerServer`` (predict / reconstruct_rows / top_k,
                    update_rows / sync_factor_rows / refresh_tables),
                    checkpoint loading, sharded modes over an in-process
                    worker mesh (``mesh=``: row-sharded tables with
                    shard-local query programs, or replicated tables
                    with split batches)
    ``policy``      the automatic row- vs batch-sharding decision
                    (table bytes × expected q/s)
    ``supervisor``  the online refresh round on a background thread, with
                    fault injection, retry, degraded mode and drift
                    escalation
    ``bucketing``   fixed-shape request bucketing
    ``frontend``    asyncio microbatch front end: bounded-queue admission,
                    shed-on-deadline, per-bucket latency percentiles, and
                    the closed-loop load harness

Entry point: ``repro_torch.launch.serve_tucker`` (``--sharded`` for the
mesh layouts).
"""
from .bucketing import bucket_for, bucket_ladder, split_batch
from .engine import TuckerServer, load_params_from_checkpoint
from .frontend import (
    AdmissionConfig, FrontendStats, RequestShed, ServeFrontend,
    run_closed_loop,
)
from .policy import ShardDecision, ShardPolicy, choose_shard_mode
from .supervisor import (
    DriftTracker, RefreshSupervisor, SupervisorConfig, window_block,
)

__all__ = [
    "RefreshSupervisor",
    "SupervisorConfig",
    "DriftTracker",
    "window_block",
    "TuckerServer",
    "load_params_from_checkpoint",
    "bucket_ladder",
    "bucket_for",
    "split_batch",
    "AdmissionConfig",
    "FrontendStats",
    "RequestShed",
    "ServeFrontend",
    "run_closed_loop",
    "ShardDecision",
    "ShardPolicy",
    "choose_shard_mode",
]
