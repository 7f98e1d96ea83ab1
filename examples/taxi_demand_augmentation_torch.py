"""The paper's Example 1, end to end, in the PyTorch port: relational
data augmentation for taxi-demand prediction.

A base table (date×zone → NumTrips) is enriched by searching a
repository of candidate tables with MI sketches: weather (joinable on
date, predictive), demographics (joinable on zone, predictive and
NONMONOTONE, which correlation-based discovery misses, Section I) and a
pile of joinable but irrelevant tables.  The discovered features feed a
small regression model (a torch ``nn.Module`` trained by autograd);
test MAE with and without augmentation is the payoff the paper promises.

    PYTHONPATH=src python examples/taxi_demand_augmentation_torch.py   # the card
    PYTHONPATH=src python examples/taxi_demand_augmentation_torch.py --device cpu

The data is generated in process from a seed; nothing is downloaded.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from repro_torch.core.discovery import SketchIndex
from repro_torch.data.pipeline import AugmentedTabularPipeline
from repro_torch.data.tables import Table
from repro_torch.device import resolve_device

N_DAYS, N_ZONES = 400, 60


def make_scenario(seed: int = 7):
    """The scenario of Figure 1: (base table, candidate tables, day and
    zone of each base row)."""
    rng = np.random.default_rng(seed)
    days = np.repeat(np.arange(N_DAYS), N_ZONES)
    zones = np.tile(np.arange(N_ZONES), N_DAYS)
    temp = 15 + 10 * np.sin(2 * np.pi * np.arange(N_DAYS) / 365) \
        + rng.normal(0, 3, N_DAYS)                      # daily temperature
    rain = np.maximum(rng.normal(0, 1, N_DAYS), 0)      # daily rainfall
    population = rng.uniform(5_000, 120_000, N_ZONES)   # per-zone population
    # Demand: rain suppresses, temperature mildly helps, population acts
    # NON-monotonically (quiet suburbs and gridlocked centers both low).
    pop_effect = -((population - 60_000) / 30_000) ** 2
    trips = (
        120
        + 2.0 * temp[days]
        - 25.0 * rain[days]
        + 40.0 * pop_effect[zones]
        + rng.normal(0, 8, N_DAYS * N_ZONES)
    ).astype(np.float32)
    key = (days.astype(np.int64) * 1000 + zones).astype(np.int64)
    base = Table("taxi", {"trip_key": key.astype(np.float64),
                          "num_trips": trips})
    repo = [
        Table("weather", {
            "trip_key": key.astype(np.float64),
            "avg_temp": temp[days].astype(np.float32),
            "rainfall": rain[days].astype(np.float32),
        }),
        Table("demographics", {
            "trip_key": key.astype(np.float64),
            "population": population[zones].astype(np.float32),
        }),
    ]
    for j in range(12):  # joinable but irrelevant tables
        repo.append(Table(f"opendata_{j:02d}", {
            "trip_key": key.astype(np.float64),
            f"col_{j}": rng.normal(size=len(key)).astype(np.float32),
        }))
    return base, repo, days, zones


class Regressor(nn.Module):
    """One tanh hidden layer of 32 units, weights ~ 0.1 N(0, 1)."""

    def __init__(self, d: int, generator: torch.Generator, device):
        super().__init__()
        self.hidden = nn.Linear(d, 32, device=device)
        self.out = nn.Linear(32, 1, device=device)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=generator,
                                          device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.tanh(self.hidden(x)))[:, 0]


def train_regressor(x: np.ndarray, y: np.ndarray, device, steps: int = 400,
                    lr: float = 1e-2, seed: int = 0) -> float:
    """Full-batch gradient descent on the L1 loss over the first 80% of
    the rows; returns the test MAE on the rest."""
    split = int(0.8 * len(x))
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Regressor(x.shape[1], gen, device)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        loss = (model(xt[:split]) - yt[:split]).abs().mean()
        loss.backward()
        opt.step()
    with torch.no_grad():
        return float((model(xt[split:]) - yt[split:]).abs().mean())


def main(device: str = "cuda", seed: int = 7) -> dict:
    """Discover, augment, train with and without the augmentation.
    Prints and returns the discovered feature names and both MAEs."""
    dev = resolve_device(device)
    base, repo, days, zones = make_scenario(seed)

    # 1. Discovery: rank every candidate column by sketch-estimated MI.
    index = SketchIndex(n=512, method="tupsk", agg="avg", device=dev)
    tables = {}
    for t in repo:
        index.add_table(t, "trip_key")
        for col in t.column_names():
            if col != "trip_key":
                tables[(t.name, col)] = (t["trip_key"].key_codes(),
                                         t[col].value_array())
    pipe = AugmentedTabularPipeline(index=index, tables=tables, top_k=3,
                                    min_join=64)
    x_aug, names = pipe.build(base["trip_key"].key_codes(),
                              base["num_trips"].value_array())
    print("discovered features (by estimated MI):")
    for n in names:
        print("   ", n)

    # 2. Train the regressor with and without the augmentation.
    y = base["num_trips"].value_array()
    y_std = (y - y.mean()) / y.std()
    baseline = np.stack([days / N_DAYS, zones / N_ZONES], axis=1) \
        .astype(np.float32)
    mae_base = train_regressor(baseline, y_std, dev)
    mae_aug = train_regressor(np.concatenate([baseline, x_aug], axis=1),
                              y_std, dev)
    print(f"\ntest MAE without augmentation : {mae_base:.4f} (standardized)")
    print(f"test MAE with augmentation    : {mae_aug:.4f}")
    print(f"improvement                   : {100 * (1 - mae_aug / mae_base):.1f}%")
    if not mae_aug < mae_base:
        raise AssertionError("augmentation should improve the model")
    return {"names": names, "mae_base": mae_base, "mae_aug": mae_aug}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    main(ap.parse_args().device)
