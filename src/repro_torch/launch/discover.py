"""Discovery launcher (PyTorch port): the paper's system end to end.

Builds a sketch index over a repository of tables (CSV directory or the
synthetic corpus), then answers one discovery query: given a base table
and target column, the top-k candidate (table, column) pairs ranked by
sketch-estimated mutual information, no join materialized.

  PYTHONPATH=src python -m repro_torch.launch.discover --synthetic 200 \
      --n 256 --top-k 10 [--device cpu] [--mesh]

``--mesh`` shards candidate scoring over the local devices: every
visible card (``make_host_mesh()``), or with ``--device cpu`` a
one-shard mesh on the CPU.  Its ranking equals the run without it.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from repro_torch.core.discovery import SketchIndex
from repro_torch.core.sketch import build_sketch
from repro_torch.data.tables import Table
from repro_torch.launch.mesh import make_host_mesh


def synthetic_corpus(n_tables: int, rng) -> tuple[list[Table], Table, str, str]:
    """A corpus with planted relationships of graded strength."""
    n_rows = 5000
    keys = np.array([f"key_{i}" for i in range(n_rows)])
    y = rng.normal(size=n_rows).astype(np.float32)
    base = Table("base", {"join_key": keys, "target": y})
    tables = []
    for t in range(n_tables):
        strength = t / max(n_tables - 1, 1)
        noise = rng.normal(size=n_rows).astype(np.float32)
        val = strength * y + (1 - strength) * noise
        perm = rng.permutation(n_rows)
        tables.append(
            Table(f"table_{t:04d}",
                  {"key": keys[perm], f"col_{t}": val[perm].astype(np.float32)})
        )
    return tables, base, "join_key", "target"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv-dir", default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="build a synthetic corpus of N tables")
    ap.add_argument("--n", type=int, default=256, help="sketch budget")
    ap.add_argument("--method", default="tupsk",
                    choices=["tupsk", "lv2sk", "prisk", "indsk", "csk"])
    ap.add_argument("--agg", default="first")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--mesh", action="store_true",
                    help="shard candidate scoring over local devices")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    index = SketchIndex(n=args.n, method=args.method, agg=args.agg,
                        device=args.device)

    if args.synthetic:
        tables, base, key_col, target_col = synthetic_corpus(args.synthetic, rng)
        t0 = time.time()
        for t in tables:
            index.add_table(t, t.column_names()[0])
        t_index = time.time() - t0
    elif args.csv_dir:
        paths = sorted(glob.glob(os.path.join(args.csv_dir, "*.csv")))
        if len(paths) < 2:
            print("need >= 2 CSVs: first is the base table", file=sys.stderr)
            return 2
        base = Table.from_csv(os.path.basename(paths[0]), paths[0])
        key_col = base.column_names()[0]
        target_col = base.column_names()[-1]
        t0 = time.time()
        for p in paths[1:]:
            t = Table.from_csv(os.path.basename(p), p)
            index.add_table(t, t.column_names()[0])
        t_index = time.time() - t0
    else:
        print("pass --synthetic N or --csv-dir", file=sys.stderr)
        return 2

    print(f"[discover] indexed {len(index)} candidate column pairs "
          f"in {t_index:.2f}s (method={args.method}, n={args.n}, "
          f"device={index.device})")

    train_sk = build_sketch(
        base[key_col].key_codes(), base[target_col].value_array(),
        n=args.n, method=args.method, side="train",
        value_is_discrete=base[target_col].is_discrete,
    )
    mesh = None
    if args.mesh:
        mesh = make_host_mesh(model=1, devices=(
            ["cpu"] if index.device.type == "cpu" else None))
    t0 = time.time()
    results = index.query(train_sk, top_k=args.top_k, mesh=mesh)
    t_query = time.time() - t0
    print(f"[discover] query over {len(index)} candidates in {t_query:.3f}s "
          f"({len(index) / max(t_query, 1e-9):.0f} cands/s)")
    for meta, mi, join_size in results:
        print(f"  MI={mi:6.3f} join={join_size:5d} "
              f"{meta.table}.{meta.value_column}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
