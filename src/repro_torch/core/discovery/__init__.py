"""MI-based data discovery engine (PyTorch port), three layers:

  * :mod:`.index` — storage: :class:`SketchIndex`, candidate sketches in
    preallocated device tensors with incremental in-place ingest;
  * :mod:`.planner` — layout: :class:`QueryPlan`, estimator groups,
    pow-2 bucket ladders, shortlists;
  * :mod:`.executors` — compute: partitioned and batched executors, and
    the fused two-phase pipeline (prefilter, compaction, gather, score).
"""

from repro_torch.core.discovery.executors import (
    BatchedExecutor,
    Executor,
    PartitionedLocalExecutor,
    stack_trains_host,
)
from repro_torch.core.discovery.index import CandidateMeta, SketchIndex
from repro_torch.core.discovery.planner import (
    MIN_SHORTLIST,
    FusedSpec,
    GroupPlan,
    QueryPlan,
    Shortlist,
    ShortlistHints,
    ShortlistOverflow,
    bucket_rows,
    bucket_shortlist,
    build_shortlists,
    estimator_id,
    fused_shortlist_spec,
    partition_by_estimator,
)

__all__ = [
    "CandidateMeta",
    "SketchIndex",
    "QueryPlan",
    "GroupPlan",
    "Shortlist",
    "ShortlistHints",
    "ShortlistOverflow",
    "FusedSpec",
    "build_shortlists",
    "fused_shortlist_spec",
    "partition_by_estimator",
    "estimator_id",
    "bucket_rows",
    "bucket_shortlist",
    "MIN_SHORTLIST",
    "Executor",
    "PartitionedLocalExecutor",
    "BatchedExecutor",
    "stack_trains_host",
]
