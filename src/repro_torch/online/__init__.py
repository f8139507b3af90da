"""Online adaptive re-fragmentation: the control plane that keeps the
paper's workload-driven fragmentation/allocation tracking a *live* query
stream instead of a build-time snapshot.

Module map (the epoch loop, in data-flow order):

* ``monitor``    -- streaming workload monitor: exponentially-decayed
                    query-shape / property frequencies, sketch-backed,
                    O(1) per executed query; feeds everything below.
* ``drift``      -- drift detection: total-variation distance of the
                    live property distribution vs. the design-time one,
                    plus Benefit-style FAP coverage loss; fires the
                    re-partition trigger.
* ``refragment`` -- incremental re-mining + re-selection on the monitor
                    snapshot, warm-started from the incumbent FAP set;
                    reuses core.mining / core.selection / core
                    fragmentation+allocation verbatim.
* ``migration``  -- cost-bounded live migration: diffs old vs. new
                    allocation, ranks moves by affinity gain per byte,
                    respects a max-bytes-per-epoch budget, never strands
                    a fragment; ships through the straggler work queue.
* ``loop``       -- ``AdaptiveEngine``: wraps core.executor (or, with
                    ``serve_backend="spmd"``, the GPU
                    ``SpmdEngine`` with hot ``SiteStore`` swaps) so
                    every query feeds the monitor; runs drift ->
                    refragment -> migrate between query epochs with
                    before/after communication-cost accounting.
* ``lifecycle``  -- versioned plan publication (``PlanRepository`` over
                    ``repro_torch.checkpoint``, provenance-chained, monitor
                    state alongside) and graph-delta ingestion
                    (``ingest_delta``: per-fragment edge *diffs*, never
                    whole-fragment re-ships).

Knobs (``AdaptiveConfig``): epoch_len, decay, tv_threshold,
coverage_drop_threshold, cooldown_epochs, migration_budget_bytes.
"""
from .drift import DriftDetector, DriftReport, pattern_coverage
from .lifecycle import (DeltaPlan, FragmentDelta, PlanRepository,
                        ingest_delta)
from .loop import AdaptiveConfig, AdaptiveEngine, EpochReport
from .migration import (BYTES_PER_EDGE, MigrationPlan, Move, fragment_key,
                        migration_work_items, plan_migration,
                        schedule_migration)
from .monitor import CountMinSketch, WorkloadMonitor, sketch_key
from .refragment import RefragmentResult, refragment, warm_mine

__all__ = [
    "WorkloadMonitor", "CountMinSketch", "sketch_key",
    "DriftDetector", "DriftReport", "pattern_coverage",
    "RefragmentResult", "refragment", "warm_mine",
    "MigrationPlan", "Move", "fragment_key", "plan_migration",
    "migration_work_items", "schedule_migration", "BYTES_PER_EDGE",
    "AdaptiveConfig", "AdaptiveEngine", "EpochReport",
    "PlanRepository", "DeltaPlan", "FragmentDelta", "ingest_delta",
]
