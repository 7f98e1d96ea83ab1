"""The port's autotuner (``repro_torch.kernels.autotune``) against
``repro.kernels.autotune`` and the contracts of ``tests/test_autotune.py``.

  * the modes: ``off`` returns the default with no file I/O, ``auto``
    never sweeps, ``on`` sweeps once, persists the winner and every later
    process (a fresh memo) reads it back; a corrupt or stale file, or an
    entry off the ladder, gives the default with a warning; ties go to the
    smaller rung; every rung failing raises;
  * parity: the same fake measure factories and backend string through
    both packages give the same winners and the same ``entries`` JSON, and
    a file written by either reads back in the other; a reference entry
    never resolves a port kernel body;
  * the port's own rules: a CPU tensor never reaches the tuner (no sweep,
    no file), a capturing stream never sweeps, a memo hit builds no
    measure factory, a factory times the calling launch's own P (the
    bucket is only the key), each tuned body's ladder check refuses an
    off-ladder value, the ladders and defaults are the CUDA sources' (the
    defaults the constants the bodies had before they were tuned), and
    the untuned bodies take no rung and keep their constants;
  * layout: every module of ``src/repro/`` has a counterpart in the port,
    but for the two with none (``launch/env.py``, ``parallel/compat.py``).

The ``cuda``-marked test holds every rung of every tuned body bit-equal
to the default rung on the card.
"""

from __future__ import annotations

import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_tune
from repro_torch.kernels import autotune
from repro_torch.kernels._build import local_includes
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.knn_stats import kernel as knn_kernel
from repro_torch.kernels.knn_stats import ops as knn_ops
from repro_torch.kernels.pairwise_cheb import kernel as pc_kernel
from repro_torch.kernels.pairwise_cheb import ops as pc_ops
from _torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
# What torch.cuda.get_device_name gives on the card the port runs on: a
# port backend is a card's name, never a jax backend ("cpu", "gpu", "tpu").
CARD = "NVIDIA H100 80GB HBM3"
# Every key name the port resolves, one per tuned body.
PORT_KERNELS = ("radius_counts_staged", "knn_two_op_staged",
                "pairwise_cheb")
# The reference's key names (knn_stats/ops.py, pairwise_cheb/ops.py,
# flash_attention/ops.py).
REF_KERNELS = ("knn_stats_pallas", "knn_stats_scan", "pairwise_cheb",
               "flash_attention")


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """Every test gets a private cache path and clean memos (both
    packages)."""
    path = tmp_path / "cache.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.clear_memo()
    ref_tune.clear_memo()
    yield path
    autotune.clear_memo()
    ref_tune.clear_memo()


def fake(times: dict):
    calls = []

    def factory(bucket, default):
        def measure(rung):
            calls.append(rung)
            return times[rung]

        return measure

    factory.calls = calls
    return factory


LADDER = (1, 2, 4, 8)
TIMES = {1: 3.0, 2: 1.0, 4: 0.5, 8: 2.0}


class TestModes:
    def test_off_returns_default_without_touching_cache(self, cache,
                                                        monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "off")
        fac = fake(TIMES)
        got = autotune.resolve("radius_counts_staged", shape=256, default=8,
                               backend=CARD, candidates=LADDER, measure=fac)
        assert got == 8 and fac.calls == [] and not cache.exists()

    def test_auto_miss_returns_default_without_sweeping(self, cache):
        fac = fake(TIMES)
        got = autotune.resolve("radius_counts_staged", shape=256, default=8,
                               backend=CARD, candidates=LADDER, measure=fac)
        assert got == 8 and fac.calls == [] and not cache.exists()

    def test_on_sweeps_persists_and_memoizes(self, cache, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        fac = fake(TIMES)
        sweeps = autotune.sweeps
        kw = dict(shape=200, default=8, backend=CARD, candidates=LADDER,
                  measure=fac)
        assert autotune.resolve("radius_counts_staged", **kw) == 4
        assert autotune.resolve("radius_counts_staged", **kw) == 4
        assert sorted(fac.calls) == list(LADDER)  # swept exactly once
        assert autotune.sweeps == sweeps + 1
        raw = json.loads(cache.read_text())
        entry = raw["entries"][f"radius_counts_staged|{CARD}|float32|256"]
        assert raw["version"] == 1
        assert entry == {"block": 4, "default": 8,
                         "seconds": {str(c): TIMES[c] for c in LADDER}}

    def test_winner_reused_across_processes(self, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        kw = dict(shape=256, default=8, backend=CARD, candidates=LADDER)
        first = autotune.resolve("pairwise_cheb", measure=fake(TIMES), **kw)
        autotune.clear_memo()  # a new process, in the default auto mode
        monkeypatch.delenv("REPRO_AUTOTUNE")
        fac = fake({})
        assert autotune.resolve("pairwise_cheb", measure=fac, **kw) == first
        assert fac.calls == []

    def test_distinct_buckets_dtypes_and_cards_resolve_apart(self,
                                                             monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        fac = fake(TIMES)
        for shape, dtype, backend in ((256, "float32", CARD),
                                      (512, "float32", CARD),
                                      (256, "bfloat16", CARD),
                                      (256, "float32", "NVIDIA H200")):
            autotune.resolve("knn_two_op_staged", shape=shape, default=8,
                             backend=backend, dtype=dtype, candidates=LADDER,
                             measure=fac)
        assert len(fac.calls) == 4 * len(LADDER)

    def test_ties_break_toward_the_smaller_rung(self, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        got = autotune.resolve("knn_two_op_staged", shape=1024, default=8,
                               backend=CARD, candidates=(1, 2, 4, 8),
                               measure=fake({1: 1.0, 2: 1.0, 4: 1.0, 8: 1.0}))
        assert got == 1

    def test_failing_rungs_are_skipped_and_all_failing_raises(self,
                                                              monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")

        def factory(ok):
            def make(bucket, default):
                def measure(rung):
                    if rung not in ok:
                        raise RuntimeError("unservable")
                    return 1.0
                return measure
            return make

        with pytest.warns(UserWarning, match="failed"):
            assert autotune.resolve("pairwise_cheb", shape=256, default=8,
                                    backend=CARD, candidates=(4, 8),
                                    measure=factory({8})) == 8
        with pytest.warns(UserWarning, match="failed"), \
                pytest.raises(RuntimeError, match="every autotune candidate"):
            autotune.resolve("pairwise_cheb", shape=512, default=8,
                             backend=CARD, candidates=(4, 8),
                             measure=factory(set()))


class TestCacheTolerance:
    def test_corrupt_and_stale_files_warn_and_give_the_default(self, cache):
        for text in ("{not json", json.dumps({"version": 99, "entries": {}}),
                     json.dumps({"version": 1})):
            cache.write_text(text)
            autotune.clear_memo()
            with pytest.warns(UserWarning, match="corrupt or stale"):
                assert autotune.resolve("pairwise_cheb", shape=256, default=8,
                                        backend=CARD,
                                        candidates=pc_kernel.ROW_STEPS) == 8

    def test_off_ladder_entry_warns_and_gives_the_default(self, cache):
        cache.write_text(json.dumps({"version": 1, "entries": {
            f"pairwise_cheb|{CARD}|float32|256": {"block": 7},
            f"knn_two_op_staged|{CARD}|float32|1024": {"block": "8"}}}))
        with pytest.warns(UserWarning, match="invalid block"):
            assert autotune.resolve("pairwise_cheb", shape=256, default=8,
                                    backend=CARD,
                                    candidates=pc_kernel.ROW_STEPS) == 8
        with pytest.warns(UserWarning, match="invalid block"):
            assert autotune.resolve("knn_two_op_staged", shape=1024,
                                    default=8, backend=CARD,
                                    candidates=(1, 2, 4, 8)) == 8


class TestBuckets:
    @pytest.mark.parametrize("n, bucket", [(1, 64), (64, 64), (65, 128),
                                           (256, 256), (300, 512),
                                           (2079, 4096), (10_000, 16384)])
    def test_shape_bucket_as_the_reference(self, n, bucket):
        assert autotune.shape_bucket(n) == bucket == ref_tune.shape_bucket(n)


class TestParity:
    """The same fake factories through both packages."""

    CASES = [("radius_counts_staged", 256, 8, (1, 2, 4, 8),
              {1: 3.0, 2: 1.0, 4: 0.5, 8: 2.0}),
             ("knn_two_op_staged", 1000, 8, (1, 2, 4, 8),
              {1: 2.0, 2: 2.0, 4: 2.0, 8: 1.0}),
             ("pairwise_cheb", 2079, 8, (4, 8, 16, 32),
              {4: 1.0, 8: 1.0, 16: 1.0, 32: 1.0})]

    def _sweep_both(self, monkeypatch, tmp_path):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        files = {}
        for name, mod in (("port", autotune), ("ref", ref_tune)):
            files[name] = tmp_path / f"{name}.json"
            monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(files[name]))
            mod.clear_memo()
            winners = [mod.resolve(k, shape=s, default=d, backend="cpu",
                                   candidates=c, measure=fake(t))
                       for k, s, d, c, t in self.CASES]
            files[name + "_winners"] = winners
        return files

    def test_same_winners_and_entries(self, monkeypatch, tmp_path):
        files = self._sweep_both(monkeypatch, tmp_path)
        assert files["port_winners"] == files["ref_winners"] == [4, 8, 4]
        assert json.loads(files["port"].read_text()) \
            == json.loads(files["ref"].read_text())
        assert files["port"].read_text() == files["ref"].read_text()

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_a_file_of_either_reads_back_in_the_other(self, monkeypatch,
                                                      tmp_path, writer):
        files = self._sweep_both(monkeypatch, tmp_path)
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(files[writer]))
        monkeypatch.delenv("REPRO_AUTOTUNE")
        reader = ref_tune if writer == "port" else autotune
        reader.clear_memo()
        got = []
        for k, s, d, c, _ in self.CASES:
            fac = fake({})
            got.append(reader.resolve(k, shape=s, default=d, backend="cpu",
                                      candidates=c, measure=fac))
            assert fac.calls == []
        assert got == files[writer + "_winners"]

    def test_environment_is_shared(self, monkeypatch):
        for raw, want in (("off", "off"), ("0", "off"), ("on", "on"),
                          ("TRUE", "on"), ("", "auto"), ("maybe", "auto")):
            monkeypatch.setenv("REPRO_AUTOTUNE", raw)
            assert autotune.mode() == ref_tune.mode() == want
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/x/y.json")
        assert autotune.cache_path() == ref_tune.cache_path()
        monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
        assert autotune.cache_path() == ref_tune.cache_path() \
            == Path("results") / "autotune_cache.json"
        assert autotune.LADDER == ref_tune.LADDER

    def test_a_reference_entry_never_resolves_a_port_body(self, cache,
                                                          monkeypatch):
        # The reference's entries for all of its kernels, on every backend
        # jax names, beside one port entry: no port body reads a
        # reference entry, and the reference reads its own.
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        for backend in ("cpu", "gpu", "tpu"):
            for k in REF_KERNELS:
                ref_tune.resolve(k, shape=256, default=256, backend=backend,
                                 measure=fake({64: 1.0, 128: 2.0, 256: 3.0,
                                               512: 4.0, 1024: 5.0}))
        assert set(PORT_KERNELS).isdisjoint(set(REF_KERNELS) - {"pairwise_cheb"})
        monkeypatch.delenv("REPRO_AUTOTUNE")
        entries = json.loads(cache.read_text())["entries"]
        assert len(entries) == 3 * len(REF_KERNELS)
        for k in PORT_KERNELS:
            assert not any(e.startswith(f"{k}|{CARD}|") for e in entries)
            fac = fake({})
            assert autotune.resolve(k, shape=256, default=2, backend=CARD,
                                    candidates=(2, 64), measure=fac) == 2
            assert fac.calls == []
        ref_tune.clear_memo()
        assert ref_tune.resolve("pairwise_cheb", shape=256, default=256,
                                backend="tpu") == 64


def _cpu_ops():
    """Every public op whose CUDA branch reaches a tuned body, on CPU
    tensors."""
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
            for _ in range(2))
    m = torch.ones(3, 40, dtype=torch.bool)
    q = torch.from_numpy(rng.normal(size=(1, 4, 33, 64)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 2, 33, 64)).astype(np.float32))
    knn_ops.knn_radius_counts(x, y, m, k=3)
    knn_ops.knn_radius_counts(torch.round(x), y, m, k=3, mode="class",
                              which="y")
    knn, _ = knn_ops.knn_smallest(x, y, m, k=3)
    knn_ops.ball_counts(x, y, m, knn[..., 2])
    pc_ops.pairwise_cheb(x, y, m)
    fa_ops.attention(q, kv, kv)
    fa_ops.attention(q.to(torch.bfloat16), kv.to(torch.bfloat16),
                     kv.to(torch.bfloat16))


class TestPortRules:
    def test_cpu_ops_never_reach_the_tuner(self, cache, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")

        def boom(*a, **k):
            raise AssertionError("a CPU op reached the tuner")

        for mod in (knn_kernel, pc_kernel):
            monkeypatch.setattr(mod, "_measure", boom)
        sweeps, launches = autotune.sweeps, autotune.sweep_launches
        _cpu_ops()
        assert not cache.exists() and not autotune._memo
        assert (autotune.sweeps, autotune.sweep_launches) == (sweeps, launches)

    def test_a_capturing_stream_never_sweeps(self, cache, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        monkeypatch.setattr(autotune, "_capturing", lambda: True)
        fac = fake(TIMES)
        kw = dict(default=8, backend=CARD, candidates=LADDER, measure=fac)
        assert autotune.resolve("pairwise_cheb", shape=256, **kw) == 8
        monkeypatch.setattr(autotune, "_capturing", lambda: False)
        # Pinned in the memo: the same key does not sweep after the capture.
        assert autotune.resolve("pairwise_cheb", shape=256, **kw) == 8
        assert fac.calls == [] and not cache.exists()
        # A cached winner is taken under capture.
        cache.write_text(json.dumps({"version": 1, "entries": {
            f"pairwise_cheb|{CARD}|float32|512": {"block": 4}}}))
        autotune.clear_memo()
        monkeypatch.setattr(autotune, "_capturing", lambda: True)
        assert autotune.resolve("pairwise_cheb", shape=512, **kw) == 4
        assert fac.calls == []

    def test_backend_on_the_cpu(self):
        assert autotune.backend_of("cpu") == "cpu"
        assert autotune.backend_of(torch.device("meta")) == "cpu"

    @pytest.mark.parametrize("entry", sorted(knn_kernel._KEY))
    def test_knn_body_ladders_refuse_off_ladder_values(self, entry):
        ladder, default = knn_kernel.TUNED[knn_kernel._KEY[entry]]
        assert default in ladder
        for rung in ladder:
            assert knn_kernel._rung(entry, rung, 2, 256, "cpu", 3, 3) == rung
        for bad in (0, 3, 2 * max(ladder), -1):
            with pytest.raises(ValueError, match="not on its ladder"):
                knn_kernel._rung(entry, bad, 2, 256, "cpu", 3, 3)

    def test_pairwise_cheb_ladder_refuses_off_ladder_values(self):
        for rung in pc_kernel.ROW_STEPS:
            assert pc_kernel._rung(rung, 256, "cpu") == rung
        for bad in (1, 2, 12, 64):
            with pytest.raises(ValueError, match="not on its ladder"):
                pc_kernel._rung(bad, 256, "cpu")

    def test_a_memo_hit_builds_no_measure_factory(self, cache, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "on")
        made = []

        def factory(*args):
            made.append(args)
            return lambda rung: TIMES[rung]

        kw = dict(ladder=LADDER, default=8, shape=256,
                  device=torch.device("cpu"), measure=factory, args=("a", 1))
        assert autotune.pick("radius_counts_staged", None, **kw) == 4
        # The factory took the caller's arguments, then the bucket and
        # the default.
        assert made == [("a", 1, 256, 8)]
        for _ in range(3):
            assert autotune.pick("radius_counts_staged", None, **kw) == 4
        assert len(made) == 1

    @pytest.mark.parametrize("body", ["radius_counts_staged",
                                      "knn_two_op_staged", "pairwise_cheb"])
    def test_a_measure_factory_times_the_calls_own_P(self, body, monkeypatch):
        """At P = 1280 (bucket 2048) the sweep's launches are at P = 1280:
        the bucket is only the cache key (the factory never checks P
        against the body's range; its launches are stubbed here)."""
        seen = []
        monkeypatch.setattr(autotune, "time_launch",
                            lambda run, launches=1: (run(), 0.0)[1])
        if body == "pairwise_cheb":
            monkeypatch.setattr(pc_kernel, "_launch", lambda x, y, m, rung:
                                seen.append((tuple(x.shape), rung)))
            from repro_torch.core.estimators import _MATERIALIZED_ELEMS

            pc_kernel._measure(1280, "cpu", 2048, 8)(4)
            assert seen == [((_MATERIALIZED_ELEMS // 1280 ** 2, 1280), 4)]
            return
        for launch in ("_launch_rc", "_launch_knn", "_launch_bc"):
            monkeypatch.setattr(knn_kernel, launch,
                                lambda entry, x, *a, rung: seen.append(
                                    (entry, tuple(x.shape), rung)))
        ladder, default = knn_kernel.TUNED[body]
        knn_kernel._measure(body, 5, 1280, 3, 3, "cpu", 2048, default)(ladder[0])
        assert {s[0] for s in seen} == set(knn_kernel._ENTRIES[body])
        assert all(s[1:] == ((5, 1280), ladder[0]) for s in seen)

    @pytest.mark.parametrize("body, source, constant", [
        (knn_kernel.radius_counts_tiled, "knn_stats/csrc/radius_counts.cu",
         r"constexpr int kChunk = 1024;"),
        (knn_kernel.knn_smallest_tiled, "knn_stats/csrc/knn_two_op.cu",
         r"constexpr int kChunk = 1024;"),
        (knn_kernel.ball_counts_tiled, "knn_stats/csrc/knn_two_op.cu",
         r"constexpr int kChunk = 1024;"),
        (fa_kernel.flash_attention_simt_regtile,
         "flash_attention/csrc/flash_attention.cu",
         r"constexpr int kRows = 128;"),
        (fa_kernel.flash_attention_wgmma, "flash_attention/csrc/flash_wgmma.cu",
         r"kStages = DK <= 128 \? 3 : 2;"),
        (fa_kernel.flash_attention_simt_basic,
         "flash_attention/csrc/flash_attention.cu", None),
    ], ids=lambda v: getattr(v, "__name__", None))
    def test_untuned_bodies_take_no_rung(self, body, source, constant):
        """The bodies left at their constants (no rung of another launch
        shape was faster on the card) take no ``rung`` and keep the
        constant in their source (with the local headers it includes)."""
        assert "rung" not in inspect.signature(body).parameters
        text = "".join(p.read_text() for p in local_includes(
            ROOT / "src" / "repro_torch" / "kernels" / source))
        if constant is not None:
            assert re.search(constant, text), constant

    def test_ladders_and_defaults_match_the_sources(self):
        """The Python ladders are the C entries' (which refuse anything
        else), and each default is the constant the body had before it
        was tuned."""
        csrc = ROOT / "src" / "repro_torch" / "kernels"

        def rungs(path, name):
            text = (csrc / path).read_text()
            got = re.search(rf"{name}\[\] = \{{([0-9, ]+)\}};", text)
            return tuple(int(v) for v in got.group(1).split(","))

        rc, two = "knn_stats/csrc/radius_counts.cu", "knn_stats/csrc/knn_two_op.cu"
        assert rungs(rc, "kWarpRungs") == rungs(two, "kWarpRungs") \
            == knn_kernel.STAGED_WARPS
        assert "kColRungs" not in (csrc / two).read_text()
        assert rungs("pairwise_cheb/csrc/pairwise_cheb.cu", "kRowSteps") \
            == pc_kernel.ROW_STEPS
        assert {k: v[1] for k, v in knn_kernel.TUNED.items()} == {
            "radius_counts_staged": 8, "knn_two_op_staged": 8}
        assert pc_kernel.ROW_STEP_DEFAULT == 8


def test_every_reference_module_has_a_port_counterpart():
    ref = {p.relative_to(ROOT / "src" / "repro")
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src" / "repro_torch")
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    missing = {str(p) for p in ref - port}
    assert missing == {"launch/env.py", "parallel/compat.py"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_rung_is_bit_equal_on_the_card(cuda_device):
    """Every rung of every tuned body against the default rung, on the
    same inputs (bit-equal, NaN positions equal)."""
    dev = cuda_device
    t = knn_kernel._tune_samples(300, 256, dev)
    x, y, m, codes, r = t["x"], t["y"], t["mask"], t["codes"], t["r"]
    cases = {
        "radius_counts_staged": lambda g: knn_kernel.radius_counts_staged(
            codes, y, m, k=3, kb=3, kk=3, mode="class", which="all", rung=g),
        "knn_two_op_staged": lambda g: (
            *knn_kernel.knn_smallest_staged(x, y, m, kb=3, mode="joint",
                                            rung=g),
            knn_kernel.ball_counts_staged(x, y, m, r, which="all", rung=g)),
    }
    for name, run in cases.items():
        ladder, default = knn_kernel.TUNED[name]
        want = run(default)
        for rung in ladder:
            for a, b in zip(run(rung), want):
                assert torch.equal(a, b), (name, rung)
    want = pc_kernel.pairwise_cheb(x, y, m, rung=pc_kernel.ROW_STEP_DEFAULT)
    for rung in pc_kernel.ROW_STEPS:
        got = pc_kernel.pairwise_cheb(x, y, m, rung=rung)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), rung
