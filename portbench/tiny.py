"""Tiny sizes of the benchmark's cells, for runs on the CPU in tests:
every configuration and traffic key the cells read, cut to seconds."""

from __future__ import annotations

import json

from portbench import harness

CONFIG = {
    "hit_mid_far": dict(n_candidates=256, rows_per_table=48, hits=16,
                        mids=64, mid_shared_rows=3, sketch_n=32, query_pool=16,
                        check_queries=4, top_k=8, min_join=6),
    "zipf_overlap": dict(n_candidates=48, rows_per_table=400, sketch_n=96,
                         query_pool=16, check_queries=4, top_k=8, keys_min=20,
                         keys_max=150, query_keys=150, zipf_max=4096),
}
TRAFFIC = {
    "closed_loop": dict(callers=8, max_q_bucket=8),
    "batch_loop": dict(batch=8),
}
WARM = dict(warm_chunk_s=0.3, warm_max_s=1.0)
SECONDS = 0.8


def shrink(cell: harness.Cell) -> harness.Cell:
    cell.config.update(CONFIG[cell.config["lake"]])
    cell.traffic.update(TRAFFIC[cell.traffic["driver"]], **WARM)
    return cell


def cell(name: str, root=harness.ROOT) -> harness.Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    return shrink(harness.find_cell(spec, name, root))
