"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped (the run is on the CPU at tiny
size) and the rest of a run is driven as the benchmark drives it."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, tiny


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mi_altered(monkeypatch):
    """An answer altered where it is produced: every mixed-KSG MI off by
    0.01 nats."""
    from repro_torch.core import estimators

    real = estimators.mixed_ksg_mi
    monkeypatch.setattr(estimators, "mixed_ksg_mi",
                        lambda *a, **kw: real(*a, **kw) + 0.01)


def _half_sample(monkeypatch):
    """Half of each joined sample left out, the estimate taken over the
    rest (the join sizes still come from the untouched prefilter)."""
    from repro_torch.core.discovery import executors

    real = executors.sketch_join_presorted

    def half(*a, **kw):
        xs, ys, matched = real(*a, **kw)
        keep = torch.zeros_like(matched)
        keep[..., ::2] = True
        return xs, ys, matched & keep
    monkeypatch.setattr(executors, "sketch_join_presorted", half)


def _candidate_dropped(monkeypatch):
    """The best candidate of every answer left out of its ranking."""
    from repro_torch.core.discovery.index import SketchIndex

    real = SketchIndex._rank
    monkeypatch.setattr(SketchIndex, "_rank",
                        lambda self, *a, **kw: real(self, *a, **kw)[1:])


@pytest.mark.parametrize("fault", [_mi_altered, _half_sample,
                                   _candidate_dropped])
@pytest.mark.parametrize("name", ["lake64k-serve", "lake64k-batch"])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = harness.run_cell(tiny.cell(name), 2**31 + 3, tiny.SECONDS, False,
                           "cpu")
    assert out["correct"] is False, out["checks"]
