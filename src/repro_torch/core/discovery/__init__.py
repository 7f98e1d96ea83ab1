"""MI-based data discovery engine (PyTorch port): storage, layout and
compute layers, and the serving front end on top:

  * :mod:`.index` — storage: :class:`SketchIndex`, candidate sketches in
    preallocated device tensors with incremental in-place ingest;
  * :mod:`.planner` — layout: :class:`QueryPlan`, estimator groups,
    pow-2 bucket ladders, shortlists, the service's signatures,
    coalescing and :class:`PlanCache`;
  * :mod:`.executors` — compute: partitioned, batched and group-major
    distributed (mesh-sharded) executors, the fused two-phase pipeline
    (prefilter, compaction, gather, score) and the phase-0 containment
    gate in front of it, each group's body a compiled program
    (:mod:`repro_torch.compile`; :func:`compile_count`);
  * :mod:`.service` — :class:`DiscoveryService` (``submit``,
    ``submit_safe``, ``submit_async``): admission control, the
    retry/fallback ladder, the non-finite fence;
  * :mod:`.resilience` — validation, outcomes, retry policy, fences and
    the fault-injection harness;
  * :mod:`.scheduler` — the micro-batch tier behind ``submit_async``.

The functional entry points :func:`score_batch`,
:func:`score_batch_reference` and :func:`score_batch_partitioned` score
a raw stacked candidate dict (``SketchIndex.stacked``) against one train
sketch, with no plan kept between calls; :func:`distributed_topk` ranks
one over a mesh.
"""

from repro_torch.compile import compile_count
from repro_torch.core.discovery.executors import (
    BatchedExecutor,
    Executor,
    GroupMajorDistributedExecutor,
    PartitionedLocalExecutor,
    _shard_topk_plan,
    distributed_topk,
    get_executor,
    pad_trains_q,
    score_batch,
    score_batch_partitioned,
    score_batch_reference,
    stack_trains,
    stack_trains_host,
    stage_trains_host,
    upload_trains,
)
from repro_torch.core.discovery.index import CandidateMeta, SketchIndex
from repro_torch.core.discovery.planner import (
    MAX_Q_BUCKET,
    MIN_SHORTLIST,
    MIN_SURVIVORS,
    CoalescedBucket,
    FusedSpec,
    GroupPlan,
    PlanCache,
    QueryPlan,
    ServicePlan,
    Shortlist,
    ShortlistHints,
    ShortlistOverflow,
    SurvivorOverflow,
    TierSpec,
    bucket_queries,
    bucket_rows,
    bucket_shortlist,
    bucket_survivors,
    build_shortlists,
    coalesce_queries,
    estimator_id,
    fused_shortlist_spec,
    make_plan,
    pack_group,
    partition_by_estimator,
    plan_signature,
    shortlist_signature,
    stage_min_containment,
    tier_spec,
)
from repro_torch.core.discovery.resilience import (
    FAULT_SITES,
    FaultPlan,
    InjectedFault,
    QueryOutcome,
    RetryPolicy,
    fence_nonfinite,
    inject_faults,
    maybe_fault,
    reference_score_pairs,
    validate_query,
)
from repro_torch.core.discovery.scheduler import (
    PRIORITIES,
    MicroBatchScheduler,
    QueryHandle,
    SchedulerBackpressure,
    SchedulerStats,
)
from repro_torch.core.discovery.service import AdmissionStats, DiscoveryService

__all__ = [
    "CandidateMeta",
    "SketchIndex",
    "DiscoveryService",
    "AdmissionStats",
    "MicroBatchScheduler",
    "QueryHandle",
    "SchedulerBackpressure",
    "SchedulerStats",
    "PRIORITIES",
    "CoalescedBucket",
    "coalesce_queries",
    "QueryPlan",
    "GroupPlan",
    "ServicePlan",
    "PlanCache",
    "Shortlist",
    "ShortlistHints",
    "ShortlistOverflow",
    "SurvivorOverflow",
    "FusedSpec",
    "TierSpec",
    "tier_spec",
    "build_shortlists",
    "fused_shortlist_spec",
    "shortlist_signature",
    "stage_min_containment",
    "make_plan",
    "pack_group",
    "partition_by_estimator",
    "estimator_id",
    "plan_signature",
    "bucket_queries",
    "bucket_rows",
    "bucket_shortlist",
    "bucket_survivors",
    "MAX_Q_BUCKET",
    "MIN_SHORTLIST",
    "MIN_SURVIVORS",
    "Executor",
    "PartitionedLocalExecutor",
    "BatchedExecutor",
    "GroupMajorDistributedExecutor",
    "get_executor",
    "stack_trains",
    "compile_count",
    "score_batch",
    "score_batch_partitioned",
    "score_batch_reference",
    "distributed_topk",
    "pad_trains_q",
    "stack_trains_host",
    "stage_trains_host",
    "upload_trains",
    "FAULT_SITES",
    "FaultPlan",
    "InjectedFault",
    "QueryOutcome",
    "RetryPolicy",
    "fence_nonfinite",
    "inject_faults",
    "maybe_fault",
    "reference_score_pairs",
    "validate_query",
]
