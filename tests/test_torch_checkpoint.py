"""The port's checkpoints, fault tolerance and training launcher.

Mirrors ``tests/test_checkpoint.py`` on the port (round trip, the LATEST
pointer, async saves, shape checks, the manager's rolling window and
resume, the preemption guard, the straggler policy and the batch plan;
``TestElasticResharding`` waits for the port's mesh), holds a
checkpoint the reference wrote of a plain dict tree restoring equal in
the port (and the other way round), and drives ``python -m
repro_torch.launch.train --device cpu`` as ``tests/test_launchers.py``
drives the reference's: a run preempted (exit 43) and resumed, and a run
resumed from a periodic checkpoint, each ending bit-equal to an
uninterrupted run, leaf by leaf.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.train import checkpoint as JC
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as C
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.fault_tolerance import (PREEMPTED_EXIT_CODE,
                                               PreemptionGuard,
                                               StragglerMonitor,
                                               plan_batch_for_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One intra-op thread count for every launcher run, so that CPU runs in
# two processes make the same float sums.
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           OMP_NUM_THREADS="2")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32)),
                   "b": torch.zeros((8,))},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)),
                   torch.ones((2, 2))],
    }


def _leaves(tree):
    from repro_torch.train.tree import named_leaves
    return named_leaves(tree)


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict)
            else [t.to("meta") for t in v] if isinstance(v, list)
            else v.to("meta") for k, v in tree.items()}


class TestRoundtrip:
    def test_save_restore_exact(self, tmp_path):
        tree = _tree(0)
        C.save(str(tmp_path), 7, tree, {"note": "hello"})
        restored, extra = C.restore(str(tmp_path), 7, _meta(tree))
        assert extra == {"note": "hello"}
        for (pa, a), (pb, b) in zip(_leaves(tree), _leaves(restored)):
            assert pa == pb and b.device.type == "cpu" and b.dtype == a.dtype
            assert torch.equal(a, b)

    def test_latest_pointer(self, tmp_path):
        tree = _tree(0)
        assert C.latest_step(str(tmp_path)) is None
        C.save(str(tmp_path), 3, tree)
        C.save(str(tmp_path), 9, tree)
        assert C.latest_step(str(tmp_path)) == 9

    def test_async_save(self, tmp_path):
        tree = _tree(1)
        t = C.save(str(tmp_path), 5, tree, blocking=False)
        tree["params"]["w"].add_(1.0)  # the snapshot was taken before
        t.join()
        assert C.latest_step(str(tmp_path)) == 5
        restored, _ = C.restore(str(tmp_path), 5, tree)
        assert torch.equal(restored["params"]["w"] + 1.0, tree["params"]["w"])

    def test_shape_mismatch_rejected(self, tmp_path):
        tree = _tree(0)
        C.save(str(tmp_path), 1, tree)
        bad = dict(tree, step=torch.zeros((3,), dtype=torch.int32))
        with pytest.raises(ValueError):
            C.restore(str(tmp_path), 1, bad)
        with pytest.raises(KeyError):
            C.restore(str(tmp_path), 1, dict(tree, extra_leaf=torch.zeros(2)))

    def test_manager_gc_and_resume(self, tmp_path):
        m = C.CheckpointManager(str(tmp_path), keep=2, save_every=1)
        tree = _tree(0)
        for s in (1, 2, 3, 4):
            m.maybe_save(s, tree, {"s": s}, blocking=True)
        assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2
        restored = m.try_resume(tree)
        assert restored is not None
        _, extra, step = restored
        assert step == 4 and extra["s"] == 4


def test_reference_checkpoint_restores_in_port(tmp_path):
    """A plain dict tree written by the reference restores in the port
    (names, shapes, dtypes, values), and the port's in the reference."""
    rng = np.random.default_rng(2)
    tree = {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                  "codes": rng.integers(-127, 128, size=(5, 3)).astype(np.int8)},
            "step": np.asarray(12, np.int32),
            "list": [np.arange(4, dtype=np.uint8), np.ones((2,), np.float32)]}
    JC.save(str(tmp_path / "ref"), 3, jax.tree_util.tree_map(jnp.asarray, tree),
            {"pipeline": {"step": 3, "seed": 0}})
    like = {"a": {"w": torch.empty((5, 3)), "codes": torch.empty((5, 3),
                                                                 dtype=torch.int8)},
            "step": torch.empty((), dtype=torch.int32),
            "list": [torch.empty((4,), dtype=torch.uint8), torch.empty((2,))]}
    got, extra = C.restore(str(tmp_path / "ref"), 3, like)
    assert extra == {"pipeline": {"step": 3, "seed": 0}}
    np.testing.assert_array_equal(got["a"]["w"].numpy(), tree["a"]["w"])
    np.testing.assert_array_equal(got["a"]["codes"].numpy(), tree["a"]["codes"])
    assert got["a"]["codes"].dtype == torch.int8 and int(got["step"]) == 12
    np.testing.assert_array_equal(got["list"][0].numpy(), tree["list"][0])
    # The other way: the port writes, the reference restores.
    C.save(str(tmp_path / "port"), 4, got)
    back, _ = JC.restore(str(tmp_path / "port"), 4,
                         jax.tree_util.tree_map(jnp.asarray, tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Both layouts agree file for file: the same names in the same order.
    mine = json.load(open(tmp_path / "port" / "step_00000004" / "MANIFEST.json"))
    theirs = json.load(open(tmp_path / "ref" / "step_00000003" / "MANIFEST.json"))
    assert [e["name"] for e in mine["leaves"]] == [e["name"] for e in theirs["leaves"]]
    assert [e["dtype"] for e in mine["leaves"]] == [e["dtype"] for e in theirs["leaves"]]


def test_train_state_round_trip_in_place(tmp_path):
    """A whole train state (model, int8 moments, step): the model's
    parameters are restored in place, the rest into new tensors."""
    cfg = M.get_config("olmo-1b", smoke=True)
    opt = O.adamw(quantized=True)
    state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                device="cpu")
    step = TS.build_train_step(cfg, opt, O.warmup_cosine(1e-2, 0, 10))
    batch = TS.batch_to_device(
        TokenPipeline(cfg, batch=2, seq=8, seed=0).next_batch(), "cpu")
    state, _ = step(state, batch)
    C.save(str(tmp_path), 1, state)
    fresh = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(9),
                                device="cpu")
    restored, _ = C.restore(str(tmp_path), 1, fresh)
    assert restored.params is fresh.params
    for (pa, a), (pb, b) in zip(_leaves(state), _leaves(restored)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    assert all(p.requires_grad for p in restored.params.parameters())


def test_bfloat16_leaf_round_trip(tmp_path):
    t = torch.randn(3, 5).to(torch.bfloat16)
    C.save(str(tmp_path), 2, {"x": t})
    manifest = json.load(open(tmp_path / "step_00000002" / "MANIFEST.json"))
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    got, _ = C.restore(str(tmp_path), 2, {"x": torch.empty(3, 5,
                                                           dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], t)


def test_restore_with_shardings_waits_for_the_mesh(tmp_path):
    C.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 2"):
        C.restore(str(tmp_path), 1, {"x": torch.zeros(2)}, shardings={"x": None})


# ---------------------------------------------------------------------------
# The launcher (tests/test_launchers.py's train half, TestCrashResume)
# ---------------------------------------------------------------------------

def _train(args, timeout=420):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=ENV, timeout=timeout, cwd=REPO)


def _final(path, steps):
    """The leaves of a run's final checkpoint, by name."""
    final = os.path.join(path, f"step_{steps:08d}")
    manifest = json.load(open(os.path.join(final, "MANIFEST.json")))
    return manifest, {e["name"]: np.load(os.path.join(final, e["file"]))
                      for e in manifest["leaves"]}


def test_train_cli():
    out = _train(["--arch", "internlm2-1.8b", "--smoke", "--steps", "6",
                  "--batch", "4", "--seq", "32", "--log-every", "5",
                  "--quantized-opt", "--device", "cpu"])
    assert out.returncode == 0, out.stdout[-800:] + out.stderr[-1500:]
    assert "done: 6 steps" in out.stdout
    assert "[train] step=5 loss=" in out.stdout


@pytest.mark.parametrize("flags, match", [
    (["--mesh", "host"], "item 2"), (["--mesh", "production"], "item 2")])
def test_train_cli_mesh_waits(flags, match):
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match=match):
        train.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", *flags])


def test_train_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "olmo-1b", "--smoke", "--steps", "1"])


class TestCrashResume:
    ARGS = ["--arch", "olmo-1b", "--smoke", "--steps", "20", "--batch", "4",
            "--seq", "32", "--save-every", "5", "--log-every", "5",
            "--quantized-opt", "--device", "cpu"]

    def test_preemption_and_resume_bit_equal(self, tmp_path):
        straight = _train(self.ARGS + ["--ckpt-dir", str(tmp_path / "a")])
        assert straight.returncode == 0, straight.stderr[-1500:]
        ck = str(tmp_path / "b")
        first = _train(self.ARGS + ["--ckpt-dir", ck,
                                    "--simulate-preemption-at", "12"])
        assert first.returncode == PREEMPTED_EXIT_CODE == 43, \
            first.stdout + first.stderr[-1500:]
        assert "preempted at step 12" in first.stdout
        manifest = json.load(open(os.path.join(ck, "step_00000012",
                                               "MANIFEST.json")))
        assert manifest["extra"]["pipeline"] == {"step": 12, "seed": 0}
        second = _train(self.ARGS + ["--ckpt-dir", ck])
        assert second.returncode == 0, second.stderr[-1500:]
        assert "resumed from step 12 (pipeline step 12)" in second.stdout
        assert "done: 8 steps" in second.stdout
        # The logged losses after the resume are the uninterrupted run's.
        tail = [l for l in straight.stdout.splitlines() if "step=15 " in l
                or "step=19 " in l]
        assert tail and all(l in second.stdout for l in tail)
        (ma, a), (mb, b) = _final(str(tmp_path / "a"), 20), _final(ck, 20)
        assert ma["extra"] == mb["extra"] == {"pipeline": {"step": 20, "seed": 0}}
        assert a.keys() == b.keys() and len(a) > 3
        for name in a:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)

    def test_resume_from_periodic_checkpoint_bit_equal(self, tmp_path):
        """A crash after step 10's periodic save: the resumed run repeats
        no step and ends as the uninterrupted one."""
        ck = str(tmp_path / "c")
        straight = _train(self.ARGS + ["--ckpt-dir", ck])
        assert straight.returncode == 0, straight.stderr[-1500:]
        _, want = _final(ck, 20)
        # Keep only the checkpoint labelled 10 (10 steps done).
        for d in os.listdir(ck):
            if d.startswith("step_") and d != "step_00000010":
                import shutil
                shutil.rmtree(os.path.join(ck, d))
        with open(os.path.join(ck, "LATEST"), "w") as f:
            f.write("10")
        manifest = json.load(open(os.path.join(ck, "step_00000010",
                                               "MANIFEST.json")))
        assert manifest["extra"]["pipeline"]["step"] == 10
        steps = [n for n in manifest["leaves"] if n["name"] == "opt_state/step"]
        assert np.load(os.path.join(ck, "step_00000010", steps[0]["file"])) == 10
        again = _train(self.ARGS + ["--ckpt-dir", ck])
        assert "resumed from step 10" in again.stdout and "done: 10 steps" in again.stdout
        _, got = _final(ck, 20)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


class TestPolicies:
    def test_preemption_guard_trigger(self):
        g = PreemptionGuard(install=False)
        assert not g.requested
        g.trigger()
        assert g.requested

    def test_straggler_detection(self):
        m = StragglerMonitor(threshold=2.0, patience=3)
        for _ in range(10):
            m.step_end(host_id=0, duration=1.0)
        assert m.flagged == []
        flagged_now = False
        for _ in range(3):
            flagged_now = m.step_end(host_id=1, duration=5.0)
        assert flagged_now and m.flagged == [1]
        assert m.ewma == pytest.approx(1.0, abs=0.01)

    def test_plan_batch(self):
        assert plan_batch_for_mesh(256, {"data": 16})["per_data_shard"] == 16
        p = plan_batch_for_mesh(256, {"pod": 2, "data": 16})
        assert p["per_data_shard"] * p["dp"] * p["grad_accum"] == 256
        p = plan_batch_for_mesh(256, {"pod": 2, "data": 8})
        assert p["per_data_shard"] * p["dp"] * p["grad_accum"] == 256
        with pytest.raises(ValueError):
            plan_batch_for_mesh(24, {"data": 16})
