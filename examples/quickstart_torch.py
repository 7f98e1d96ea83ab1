"""Quickstart (PyTorch port): estimate mutual information across two
tables WITHOUT materializing their join (the paper's core operation).

    PYTHONPATH=src python examples/quickstart_torch.py                # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The data is generated in process from a seed; nothing is downloaded.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import estimators, synthetic
from repro_torch.core.join import full_left_join, sketch_join
from repro_torch.core.sketch import build_sketch
from repro_torch.device import resolve_device


def _mle(js, device) -> float:
    """MLE mutual information of a (discrete, discrete) join sample."""
    return float(estimators.estimate_mi(
        torch.as_tensor(js.x, device=device)[None],
        torch.as_tensor(js.y, device=device)[None],
        torch.as_tensor(js.mask, device=device)[None],
        x_discrete=True, y_discrete=True,
    )[0])


def main(device: str = "cuda", seed: int = 0, n_rows: int = 20_000,
         m: int = 512, i_target: float = 2.0, n: int = 256) -> dict:
    """Print and return the true MI, the sketch estimate and the
    full-join estimate of one Trinomial pair (KeyDep decomposition)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    # 1. Two joinable tables with a KNOWN post-join MI of ~2 nats
    #    (Trinomial generator, paper Section V-A).
    pair = synthetic.gen_trinomial(n_rows=n_rows, m=m, i_target=i_target,
                                   rng=rng)
    train_tbl, cand_tbl = synthetic.decompose(pair, "keydep", rng)
    print(f"true post-join MI           : {pair.true_mi:.4f} nats")

    # 2. TUPSK sketches of each table on its own (at ingestion time, one
    #    pass per table: the tables never meet).
    st = build_sketch(train_tbl["key_hashes"], train_tbl["values"],
                      n=n, method="tupsk", side="train")
    sc = build_sketch(cand_tbl["key_hashes"], cand_tbl["values"],
                      n=n, method="tupsk", side="cand", agg="first")
    print(f"sketch sizes                : {st.size} + {sc.size} rows "
          f"(vs {n_rows} per table)")

    # 3. Join the SKETCHES and estimate MI on the device.
    js = sketch_join(st, sc)
    mi_sketch = _mle(js, dev)
    print(f"sketch-estimated MI         : {mi_sketch:.4f} nats "
          f"(join sample = {js.size} rows; {dev})")

    # 4. Reference: the fully materialized join.
    fj = full_left_join(train_tbl["key_hashes"], train_tbl["values"],
                        cand_tbl["key_hashes"], cand_tbl["values"])
    mi_full = _mle(fj, dev)
    print(f"full-join MI (reference)    : {mi_full:.4f} nats "
          f"(join = {fj.size} rows)")
    return {"true_mi": pair.true_mi, "sketch_mi": mi_sketch,
            "full_mi": mi_full, "sketch_join_size": js.size,
            "full_join_size": fj.size}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    main(ap.parse_args().device)
