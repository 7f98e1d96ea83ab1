"""Streaming kNN statistics for the KSG-family estimators.

``ops.py`` is the public entry, ``ref.py`` the plain PyTorch version,
``kernel.py`` the ctypes bindings of ``csrc/radius_counts.cu`` (the fused
radius+count on the discovery path) and ``csrc/knn_two_op.cu`` (the
two-op ``knn_smallest`` / ``ball_counts`` behind ``knn_with_counts``).
"""

from repro_torch.kernels.knn_stats.ops import (
    BallCounts,
    ball_counts,
    knn_radius_counts,
    knn_smallest,
    knn_with_counts,
)

__all__ = ["BallCounts", "ball_counts", "knn_radius_counts", "knn_smallest",
           "knn_with_counts"]
