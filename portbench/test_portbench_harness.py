"""The benchmark's harness on the CPU at tiny sizes: every cell loads by
name and runs through the same harness with the port's plain paths, the
result line has the contract's keys, a cell that the test defines in a
checkout of its own runs with no edit to any file, and nothing the
harness loads is JAX or the JAX package."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import harness, tiny

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _result(capsys, out: dict) -> dict:
    harness.emit(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    checks = [ln for ln in captured.err.strip().splitlines()]
    assert checks[-len(out["checks"]):] == [
        f"check {k} {c['value']} limit {c['limit']}"
        for k, c in out["checks"].items()]
    return line


def test_spec_keys_names_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"queries_per_s", "query_p95_ms", "setup_s"} <= e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_and_is_correct(name, capsys):
    cell = tiny.cell(name)
    line = _result(capsys, harness.run_cell(cell, 2**31 + 7, tiny.SECONDS,
                                            False, "cpu"))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["checks"]["mi_gap"]["value"] < 1e-5


def test_traced_tiny_run_reports_the_host_layers(capsys):
    cell = tiny.cell("lake64k-serve")
    line = _result(capsys, harness.run_cell(cell, 11, 2.0, True, "cpu"))
    assert line["correct"] is True
    assert {"coalesce_ratio", "ingest_s", "shortlist_overflows",
            "programs_built_in_window", "program_build_s"} <= set(line["metrics"])
    assert not set(line["metrics"]) & {m["name"] for m in SPEC["end_to_end"]}
    assert line["metrics"]["coalesce_ratio"]["value"] >= 1
    assert "window_s" in line["device"] and "breakdown" in line


def test_a_cell_added_as_files_runs_without_edits(tmp_path, capsys):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new spec entries, in a checkout of their own."""
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        (base / sub).mkdir(parents=True)
    cfg = json.loads((ROOT / "portbench/configs/lake64k-n256.json").read_text())
    cfg.update(tiny.CONFIG["hit_mid_far"], n_candidates=128, hits=8, mids=32)
    (base / "configs/tiny-lake.json").write_text(json.dumps(cfg))
    traffic = dict(driver="closed_loop", callers=4, priority="batch",
                   window_ms=1.0, pipeline_depth=1, max_depth=64,
                   max_q_bucket=4, min_containment=0.0, **tiny.WARM)
    (base / "traffic/slow4.json").write_text(json.dumps(traffic))
    (base / "metrics/answered.py").write_text(textwrap.dedent('''
        def read(ctx):
            return ctx.delta("coalesced_queries")
    '''))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny-lake", "source": "a test",
                            "file": "portbench/configs/tiny-lake.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-serve", "config": "tiny-lake",
                              "traffic": "slow4", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "answered", "unit": "count",
                              "better": "higher", "source": "program_counter",
                              "layer": "service", "moves": "queries_per_s",
                              "workloads": ["tiny-serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell(spec, "tiny-serve", tmp_path)
    assert [m["name"] for m in cell.per_layer][-1] == "answered"
    line = _result(capsys, harness.run_cell(cell, 5, 1.5, True, "cpu"))
    assert line["correct"] is True
    assert line["metrics"]["answered"]["value"] > 0


def test_forbidden_names_compare_whole(monkeypatch):
    import repro_torch  # noqa: F401

    assert not [m for m in harness.forbidden_modules()
                if m.startswith("repro_torch")]
    monkeypatch.setitem(sys.modules, "repro.core", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "jaxlibx", sys.modules["json"])
    found = harness.forbidden_modules()
    assert "repro.core" in found and "jaxlibx" not in found


_PROBE = """
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str) else None)
import torch
torch.set_num_threads(1)
from portbench import harness, tiny
out = harness.run_cell(tiny.cell("lake64k-serve"), 3, 0.5, False, "cpu")
root = str(harness.ROOT)
print(json.dumps({"correct": out["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "benchmarks": [p for p in opened
                                 if p.startswith(root + "/benchmarks")]}))
"""


def test_a_run_loads_no_jax_and_opens_no_jax_benchmark():
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "repro_torch" in got["modules"]
    assert not set(got["modules"]) & set(harness.FORBIDDEN)
    assert got["benchmarks"] == []


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA card: a non-zero exit and no result line; the same in a
    directory that holds only the benchmark's own files."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    only = tmp_path / "only"
    shutil.copytree(ROOT / "portbench", only / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", only)
    for where in (ROOT, only):
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "lake64k-serve",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=where, capture_output=True, text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
        assert proc.returncode != 0 and proc.stdout.strip() == ""
