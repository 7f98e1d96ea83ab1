"""One run of one cell: set-up, a timed window, the trace, the check.

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``.  Set-up draws the lake from the seed (``lakes/``),
ingests it through ``SketchIndex.add``, builds the query pool's train
sketches, and warms the traffic (``drivers/``) until no more programs
are built.  The window then drives the traffic for ``--seconds`` on the
client's clock.  With ``--trace 1`` a profiler slice sits inside the
window and the per-layer readers (``metrics/``) report; with
``--trace 0`` the end-to-end metrics do.  After the window the program
is freed and a sample of the window's answers, drawn from the seed, is
held against the plain reference (``reference/``): that decides
``correct``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from portbench import drivers, trace
from portbench.reference import check

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The profiler slice: from a quarter into the window, for half of it at
# most.
SLICE_AT, SLICE_MAX_S = 0.25, 3.0


def load_module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py``, else the one under ``portbench/``,
    loaded by path."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    base: Path = HERE


def find_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of a benchmark spec, with its configuration and
    traffic files read and the metrics that apply to it.  ``root`` is the
    checkout the spec's paths are relative to."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r}; have {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    base = root / "portbench"
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer, base)


class Context:
    """What a per-layer reader reads: counters before and after the
    window, set-up times, the reduced trace slice, and what the reader's
    own ``capture`` returned (None without one)."""

    def __init__(self, before, after, setup, trace_):
        self.before, self.after = before, after
        self.setup, self.trace = setup, trace_
        self.captured = None

    def delta(self, name: str):
        if name not in self.before or name not in self.after:
            return None
        return self.after[name] - self.before[name]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _counters(index, driver) -> dict:
    from repro_torch import compile as programs

    return {"compile_count": programs.compile_count(),
            "shortlist_overflows": index.shortlist_hints.overflows,
            **driver.counters()}


def _ingest(lake, cfg, device):
    from repro_torch.core.discovery import SketchIndex

    keys, values = lake.host_tables()
    index = SketchIndex(n=cfg["sketch_n"], method=cfg["sketch_method"],
                        agg=cfg["agg"], device=device)
    for c, name in enumerate(lake.names):
        disc = bool(lake.discrete[c])
        index.add(name, "k", "v", keys[c],
                  values[c].astype(np.int64) if disc else values[c], disc)
    index.plan(False)
    index.plan(True)
    _sync(device)
    return index


def _train_sketches(lake, cfg):
    from repro_torch.core.sketch import build_sketch

    keys = lake.query_keys.cpu().numpy().astype(np.uint32)
    vals = lake.query_values.cpu().numpy()
    return [build_sketch(keys, vals[q].astype(np.int64) if d else vals[q],
                         n=cfg["sketch_n"], method=cfg["sketch_method"],
                         side="train",
                         value_is_discrete=bool(d))
            for q, d in enumerate(lake.query_discrete)]


def _warm(driver, traffic) -> int:
    """Warm the traffic until a chunk builds no program; chunks run."""
    from repro_torch import compile as programs

    t_end = time.perf_counter() + traffic["warm_max_s"]
    chunks, last = 0, programs.compile_count()
    while True:
        driver.run(traffic["warm_chunk_s"])
        chunks += 1
        now = programs.compile_count()
        if (now == last and chunks >= 2) or time.perf_counter() > t_end:
            return chunks
        last = now


def _drop_programs():
    """Drop every captured program and its graph pool: the window is
    over, and what runs after it (captures, the reference) runs eager.
    The program module has no public call for this."""
    from repro_torch import compile as programs

    with programs._LOCK:
        for p in programs._PROGRAMS:
            p._entries.clear()
        programs._POOLS.clear()
    _free()


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample_answers(answers: list, n: int, seed: int) -> list:
    """``n`` answers of the window drawn from the seed."""
    rng = np.random.default_rng([seed, 0xC4EC])
    take = rng.choice(len(answers), min(n, len(answers)), replace=False)
    return [answers[i] for i in sorted(take)]


def judge(lake, answers: list, failed: int, cfg: dict, seed: int) -> dict:
    """The numbers compared, each with its limit, for a sample of the
    window's answers held against the reference."""
    picked = sample_answers(answers, cfg["check_queries"], seed)
    where = {name: i for i, name in enumerate(lake.names)}
    served = [(q, [(where[t], mi, js) for t, mi, js in res])
              for q, _, _, _, res in picked]
    scores = check.reference_scores(lake, [q for q, _ in served], cfg)
    readings = check.compare(served, scores, cfg)
    readings["failed"] = failed
    readings["checked"] = len(served)
    limits = dict(cfg["limits"])
    limits["checked"] = None
    return {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}


def is_correct(checks: dict) -> bool:
    if checks["checked"]["value"] == 0:
        return False
    return all(c["value"] <= c["limit"] for k, c in checks.items()
               if c["limit"] is not None)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t0: float | None = None) -> dict:
    """One run of ``cell``; the result line's object."""
    from repro_torch import compile as programs

    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    readers = {m["name"]: load_module("metrics", m["name"], cell.base)
               for m in cell.per_layer} if traced else {}
    lake = load_module("lakes", cfg["lake"], cell.base).make(cfg, seed, device)
    t_ingest = time.perf_counter()
    index = _ingest(lake, cfg, device)
    ingest_s = time.perf_counter() - t_ingest
    sketches = _train_sketches(lake, cfg)
    driver = load_module("drivers", traffic["driver"], cell.base).make(
        index, cfg, traffic, sketches, lake.query_discrete, seed)
    chunks = _warm(driver, traffic)
    _sync(device)
    setup = {"ingest_s": ingest_s,
             "program_build_s": programs.compile_stats()["build_s"]}
    setup_s = time.perf_counter() - t0
    _log(f"set-up {setup_s:.3f} s (ingest {ingest_s:.3f} s, "
         f"{chunks} warm chunks, {programs.compile_count()} programs)")

    before = _counters(index, driver)
    slicer = trace.Slice(
        seconds * SLICE_AT, min(SLICE_MAX_S, seconds / 2),
        {n: r.launches for n, r in readers.items() if hasattr(r, "launches")}) \
        if traced else None
    if slicer is not None:
        slicer.prepare()
    with trace.spans() if traced else contextlib.nullcontext() as spans:
        win = driver.run(seconds, tick=slicer)
        if slicer is not None:
            slicer.finish()
    after = _counters(index, driver)
    _sync(device)
    # Reserved, not allocated: the programs' CUDA-graph pools are held
    # whole while their graphs live.
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    driver.close()
    _drop_programs()

    ok = [a for a in win.answers if a[3]]
    captured = {}
    if traced and device.type == "cuda":
        batches = [[sketches[q] for q in ids] for ids in drivers.window_buckets(
            ok, lake.query_discrete, driver.round_size, driver.bucket)]
        for name, r in readers.items():
            if hasattr(r, "capture"):
                captured[name] = r.capture(index, batches, cfg)
                _log(f"{name} capture: {captured[name]}")
    reduced = None
    if slicer is not None:
        reduced = trace.reduce(slicer.events, spans, slicer.start)
        if reduced is not None:
            reduced["queries"] = sum(slicer.start <= a[2] <= slicer.stop
                                     for a in ok)
            _log(f"trace slice {reduced['window_s']} s: "
                 f"{len(reduced['kernels'])} device records, "
                 f"{reduced['queries']} queries answered")
            for name, r in readers.items():
                if hasattr(r, "KERNEL"):
                    records = sum(r.KERNEL in n for n, _, _ in reduced["kernels"])
                    _log(f"{r.KERNEL}: {records} kernel records, "
                         f"{slicer.launches[name]} launches counted by the port")
    del driver, index, sketches
    _free()

    failed = sum(not a[3] for a in win.answers + win.late) + win.lost
    checks = judge(lake, ok, failed, cfg, seed)
    if traced:
        ctx = Context(before, after, setup, reduced)
        metrics = {}
        for m in cell.per_layer:
            ctx.captured = captured.get(m["name"])
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        lat = np.array([(a[2] - a[1]) * 1e3 for a in ok])
        values = {"queries_per_s": len(ok) / (win.end - win.start),
                  "query_p95_ms": float(np.percentile(lat, 95)) if len(lat)
                  else None,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    out = {
        "correct": is_correct(checks),
        "attempted": len(win.answers) + len(win.late) + win.lost,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else device.type,
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if reduced is not None:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def emit(out: dict) -> None:
    """The checks as the last lines of standard error, the result as
    the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"needs {cell.chips} CUDA card(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        _log(f"JAX or the JAX package was loaded: {bad}")
        return 3
    emit(out)
    return 0
