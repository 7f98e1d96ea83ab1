"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16, the precision below the configurations'
float32, must fail the comparison.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

draws the cell's lake and the queries a run would check from each seed,
ranks them by the bfloat16 reference (distances in bfloat16, tails in
float32) and holds those rankings against the float32 reference as a
run's answers are held; one JSON line of readings per seed.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from portbench import harness  # noqa: E402
from portbench.reference import check, sketch  # noqa: E402


def readings(cell, seed: int, device) -> dict:
    cfg = cell.config
    lake = harness.load_module("lakes", cfg["lake"], cell.base).make(
        cfg, seed, torch.device(device))
    answers = [(q, 0.0, 0.0, True, None) for q in range(len(lake.query_discrete))]
    qids = [a[0] for a in harness.sample_answers(
        answers, cfg["check_queries"], seed)]
    cands = sketch.cand_sketches(lake.keys, lake.values, cfg["sketch_n"])
    ref = check.reference_scores(lake, qids, cfg, cands)
    low = check.reference_scores(lake, qids, cfg, cands, dist=torch.bfloat16,
                                 tail=torch.float32)
    ranked = check.reference_rankings(low, cfg)
    out = check.compare([(q, ranked[q]) for q in qids], ref, cfg)
    out["checked"] = len(qids)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(spec, args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        r = readings(cell, seed, device)
        limits = cell.config["limits"]
        r["fails"] = sorted(k for k, v in limits.items()
                            if k in r and r[k] > v)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
