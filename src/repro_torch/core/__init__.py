"""The paper's primary contribution in the PyTorch port: sketch-based
mutual-information estimation over joins, for relational data
augmentation and discovery.

Layers:
  hashing     — murmur3 / Fibonacci coordinated-sampling primitives
  aggregate   — featurization (AGG) for many-to-many join keys
  sketch      — TUPSK (paper), LV2SK/PRISK baselines, INDSK/CSK baselines
  join        — sketch joins (host, lexsort, presorted) and the full join
  estimators  — MLE / KSG / MixedKSG / DC-KSG over padded batches
  synthetic   — Trinomial/CDUnif data with analytic true MI
  discovery   — the device-resident index, executors and service
"""

from repro_torch.core import aggregate, estimators, hashing, join, sketch, synthetic
from repro_torch.core.discovery import SketchIndex
from repro_torch.core.estimators import estimate_mi
from repro_torch.core.join import full_left_join, sketch_join
from repro_torch.core.sketch import SKETCH_METHODS, Sketch, build_sketch

__all__ = [
    "aggregate",
    "estimators",
    "hashing",
    "join",
    "sketch",
    "synthetic",
    "SketchIndex",
    "estimate_mi",
    "full_left_join",
    "sketch_join",
    "SKETCH_METHODS",
    "Sketch",
    "build_sketch",
]
