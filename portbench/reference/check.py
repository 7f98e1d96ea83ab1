"""The comparison that decides a run's ``correct``.

:func:`reference_scores` rebuilds every candidate sketch and the train
sketch of each sampled query from the lake's raw tables, joins them and
estimates MI for every candidate that reaches ``min_join``;
:func:`reference_rankings` ranks those as the system must (MI
descending, candidate order on ties, ``top_k`` long).  :func:`compare`
holds served answers against them and returns the numbers compared:

* ``count_mismatch``: answers whose length is not min(top_k, eligible);
* ``join_mismatch``: served entries whose join size differs, or that
  name a candidate below ``min_join``;
* ``mi_gap``: the widest |served MI - reference MI| of a served entry;
* ``rank_gap``: how far the served ranking departs from the reference's
  order by reference MI: the best unserved eligible candidate above the
  worst served one, or a served entry above the one before it (0 when
  the ranking is exact up to ties).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import estimators, sketch

ESTIMATORS = {  # (candidate discrete, target discrete) -> estimator
    (False, False): "mixed",
    (True, True): "mle",
    (True, False): "dc_x",
    (False, True): "dc_y",
}


def _compact(x, y, m):
    """Matched rows first in every sample, cut to the longest sample."""
    order = torch.sort((~m).to(torch.int8), dim=-1, stable=True).indices
    P = max(int(m.sum(-1).max()), 1) if m.numel() else 1
    take = order[:, :P]
    return x.gather(-1, take), y.gather(-1, take), m.gather(-1, take)


def _estimate(kind, x, y, m, k, dist, tail):
    x, y, m = _compact(x, y, m)
    if kind == "mixed":
        return estimators.mixed_ksg(x, y, m, k, dist, tail)
    if kind == "mle":
        return estimators.mle(x, y, m, k, dist, tail)
    if kind == "dc_x":
        return estimators.dc_ksg(x, y, m, k, dist, tail)
    return estimators.dc_ksg(y, x, m, k, dist, tail)


def reference_scores(lake, qids, cfg: dict, cands=None, dist=torch.float32,
                     tail=torch.float64) -> dict:
    """{qid: (join sizes (C,) int64, MI (C,) float64, NaN below min_join)}.
    ``cands``: the lake's candidate sketches, when already built."""
    if (cfg["sketch_method"], cfg["agg"]) != ("tupsk", "first"):
        raise ValueError("the reference rebuilds TUPSK sketches with AGG first")
    n, k, min_join = cfg["sketch_n"], cfg["k"], cfg["min_join"]
    ck, cv = cands if cands is not None else sketch.cand_sketches(
        lake.keys, lake.values, n)
    disc = torch.as_tensor(lake.discrete, device=ck.device)
    out = {}
    for q in sorted(set(qids)):
        tk, ty = sketch.train_sketch(lake.query_keys, lake.query_values[q], n)
        x, matched, js = sketch.join(tk, ck, cv)
        mi = torch.full((ck.shape[0],), float("nan"), dtype=torch.float64,
                        device=ck.device)
        y_disc = bool(lake.query_discrete[q])
        for c_disc in (False, True):
            rows = torch.nonzero((js >= min_join) & (disc == c_disc))[:, 0]
            if rows.numel():
                y = ty[None].expand(rows.numel(), -1)
                kind = ESTIMATORS[(c_disc, y_disc)]
                mi[rows] = _estimate(kind, x[rows], y, matched[rows], k, dist,
                                     tail).to(torch.float64)
        out[q] = (js.cpu().numpy().astype(np.int64), mi.cpu().numpy())
    return out


def rank(js: np.ndarray, mi: np.ndarray, top_k: int, min_join: int) -> list:
    """[(candidate, mi, join size)] best first: MI descending, candidate
    order on ties, only candidates at ``min_join`` or more."""
    ok = np.flatnonzero(js >= min_join)
    order = ok[np.lexsort((ok, -mi[ok]))][:top_k]
    return [(int(c), float(mi[c]), int(js[c])) for c in order]


def reference_rankings(scores: dict, cfg: dict) -> dict:
    return {q: rank(js, mi, cfg["top_k"], cfg["min_join"])
            for q, (js, mi) in scores.items()}


def compare(served: list, scores: dict, cfg: dict) -> dict:
    """``served``: [(qid, [(candidate, mi, join size), ...]), ...]."""
    top_k, min_join = cfg["top_k"], cfg["min_join"]
    out = {"count_mismatch": 0, "join_mismatch": 0, "mi_gap": 0.0,
           "rank_gap": 0.0}
    for q, answer in served:
        js, mi = scores[q]
        eligible = js >= min_join
        if len(answer) != min(top_k, int(eligible.sum())):
            out["count_mismatch"] += 1
        ref_mi = []
        for c, v, j in answer:
            if j != js[c] or not eligible[c]:
                out["join_mismatch"] += 1
                continue
            out["mi_gap"] = max(out["mi_gap"], abs(float(v) - float(mi[c])))
            ref_mi.append(float(mi[c]))
        if not ref_mi:
            continue
        gap = max([0.0] + [b - a for a, b in zip(ref_mi, ref_mi[1:])])
        unserved = eligible.copy()
        unserved[[c for c, _, _ in answer]] = False
        if unserved.any():
            gap = max(gap, float(mi[unserved].max()) - min(ref_mi))
        out["rank_gap"] = max(out["rank_gap"], gap)
    return out
