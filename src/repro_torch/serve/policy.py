"""Automatic row- vs batch-sharding policy for the serving tables.

The port's copy of ``repro.serve.policy`` (pure Python, the same branches
and reasons).  Two sharded deployments of the same ``TuckerServer`` API:

  * **row** — the C^(n) tables are ROW-sharded over the mesh's ``data``
    workers (the strata training layout).  Memory scales 1/M per worker,
    so this is the only option when the tables don't fit replicated;
    every query pays small copies between workers (the row-owner gather
    of the query rows, plus — for top_k — one all-gather of the M·k local
    candidates).
  * **batch** — the tables are REPLICATED and the request batch is split
    over the workers.  No copies between workers per query and throughput
    that scales with M, but every worker holds the full tables — the
    small-table / high-QPS deployment.

The decision hinges on two observables: total table bytes (can we afford
M replicas?) and the expected query rate (is there enough traffic for
batch-parallelism to pay its replication rent?).  ``ShardPolicy.decide``:

    table_bytes > replicate_bytes_ceiling          → row   (must shard)
    expected_qps ≥ qps_batch_threshold             → batch (traffic pays)
    otherwise                                      → row   (memory-safe
                                                    default)

Thresholds are dataclass fields so deployments (and tests) can tune them
without touching the engine.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardDecision:
    """The policy's verdict plus the evidence it was made from."""

    mode: str                    # "row" | "batch"
    table_bytes: int             # total C^(n) bytes (one replica)
    num_devices: int             # mesh `data` extent M
    expected_qps: float | None   # declared traffic, None = unknown
    reason: str                  # one-line human-readable rationale

    def __str__(self) -> str:
        qps = ("unknown" if self.expected_qps is None
               else f"{self.expected_qps:.0f}")
        return (f"{self.mode}-sharded (tables "
                f"{self.table_bytes / 2**20:.1f} MiB, M={self.num_devices}, "
                f"qps={qps}): {self.reason}")


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    """Tunable thresholds for :class:`ShardDecision`.

    ``replicate_bytes_ceiling`` is the largest table set a single worker
    is allowed to hold replicated (beyond it, row-sharding is mandatory).
    ``qps_batch_threshold`` is the traffic level above which splitting
    batches over M workers beats paying the row mode's per-query copies.
    """

    replicate_bytes_ceiling: int = 256 << 20     # 256 MiB / worker
    qps_batch_threshold: float = 512.0           # queries / second

    def decide(self, table_bytes: int, num_devices: int,
               expected_qps: float | None = None) -> ShardDecision:
        if num_devices <= 1:
            # degenerate mesh: both modes are the unsharded computation;
            # keep the row layout so checkpoint/table handling is uniform
            return ShardDecision("row", table_bytes, num_devices,
                                 expected_qps, "single device — modes "
                                 "coincide, keeping the row layout")
        if table_bytes > self.replicate_bytes_ceiling:
            return ShardDecision(
                "row", table_bytes, num_devices, expected_qps,
                f"tables exceed the {self.replicate_bytes_ceiling >> 20} MiB "
                "replication ceiling — row-sharding is mandatory")
        if (expected_qps is not None
                and expected_qps >= self.qps_batch_threshold):
            return ShardDecision(
                "batch", table_bytes, num_devices, expected_qps,
                f"tables fit replicated and traffic ≥ "
                f"{self.qps_batch_threshold:.0f} q/s — batch-parallel "
                "serving scales with M at zero per-query collectives")
        return ShardDecision(
            "row", table_bytes, num_devices, expected_qps,
            "tables fit replicated but traffic is unknown/low — "
            "defaulting to the memory-safe row layout")


DEFAULT_POLICY = ShardPolicy()


def choose_shard_mode(table_bytes: int, num_devices: int,
                      expected_qps: float | None = None,
                      policy: ShardPolicy | None = None) -> ShardDecision:
    """Module-level convenience over :meth:`ShardPolicy.decide`."""
    return (policy or DEFAULT_POLICY).decide(table_bytes, num_devices,
                                             expected_qps)
