"""Synthetic data with analytically known mutual information (paper
Section V-A), the port's own copy of ``repro.core.synthetic`` (numpy
only; keys hash with :func:`repro_torch.core.hashing.murmur3_32_np`).

Two post-join (X, Y) distributions:

  * ``Trinomial`` — (X, Y) are the first two components of a
    Multinomial(m, <p1, p2>).  (p1, p2) are *selected* through the
    bivariate-normal CLT approximation to hit a target MI; the true MI
    reported is exact, from the open-form trinomial pmf.
  * ``CDUnif`` — X ~ U{0..m−1} discrete, Y | X ~ U[X, X+2] continuous;
    I(X; Y) = ln m − (m−1) ln 2 / m (natural log).

and two decompositions into joinable tables:

  * ``KeyInd`` — unique sequential keys (one-to-one join, key ⊥ data).
  * ``KeyDep`` — the join key *equals* the X value (many-to-one join,
    maximal key/feature dependence; key frequencies follow X's marginal).

The same ``Generator`` state gives the same arrays and the same true MI
as the reference, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from numpy.random import Generator

from repro_torch.core import hashing

__all__ = [
    "GeneratedPair",
    "trinomial_params_for_mi",
    "true_trinomial_mi",
    "gen_trinomial",
    "gen_cdunif",
    "cdunif_true_mi",
    "decompose",
]

# Murmur seed of the decomposed tables' join keys (the reference's).
_KEY_SEED = 7


@dataclass
class GeneratedPair:
    """A generated post-join (X, Y) sample plus its exact MI in nats."""

    x: np.ndarray
    y: np.ndarray
    true_mi: float
    x_is_discrete: bool
    y_is_discrete: bool
    params: dict


def trinomial_params_for_mi(i_true: float, rng: Generator) -> tuple[float, float]:
    """Select (p1, p2) so the CLT-equivalent bivariate normal has MI
    ``i_true`` (the paper's parameter-selection algorithm, Section V-A)."""
    r = np.sqrt(1.0 - np.exp(-2.0 * i_true))
    for _ in range(1000):
        p1 = rng.uniform(0.15, 0.85)
        # |r| = p1 p2 / sqrt(p1(1-p1) p2(1-p2))  =>  closed form for p2.
        r2 = r * r
        p2 = r2 * (1.0 - p1) / (p1 + r2 * (1.0 - p1))
        if 0.15 <= p2 <= 0.85 and p1 + p2 < 1.0:
            return p1, p2
    raise RuntimeError(f"could not find trinomial params for MI={i_true}")


def _logfact_table(upto: int) -> np.ndarray:
    """Exact ln(z!) for z = 0..upto, as a cumulative-log table.  numpy's
    cumsum accumulates in order, so every entry equals the reference's
    (which grows one cached table on demand)."""
    return np.concatenate(
        [[0.0], np.cumsum(np.log(np.arange(1, upto + 1, dtype=np.float64)))]
    )


def true_trinomial_mi(m: int, p1: float, p2: float) -> float:
    """Exact I(X;Y) for (X,Y) ~ the first two coordinates of
    Multinomial(m, p1, p2): H(X) + H(Y) − H(X, Y) with X ~ Bin(m, p1),
    Y ~ Bin(m, p2) and the joint trinomial pmf in log space, over the
    O(m²) grid."""
    table = _logfact_table(m + 1)

    def logfact(z):
        return table[np.asarray(z, dtype=np.int64)]

    p3 = 1.0 - p1 - p2
    xs = np.arange(m + 1, dtype=np.int64)

    def entropy_binomial(p: float) -> float:
        logpmf = (
            logfact(m)
            - logfact(xs)
            - logfact(m - xs)
            + xs * np.log(p)
            + (m - xs) * np.log1p(-p)
        )
        pmf = np.exp(logpmf)
        return float(-np.sum(pmf * logpmf))

    x_grid, y_grid = np.meshgrid(xs, xs, indexing="ij")
    valid = (x_grid + y_grid) <= m
    z_grid = np.where(valid, m - x_grid - y_grid, 0)
    logpmf_joint = np.where(
        valid,
        logfact(m)
        - logfact(x_grid)
        - logfact(y_grid)
        - logfact(z_grid)
        + x_grid * np.log(p1)
        + y_grid * np.log(p2)
        + z_grid * np.log(p3),
        -np.inf,
    )
    pmf = np.where(valid, np.exp(logpmf_joint), 0.0)
    safe_log = np.where(valid, logpmf_joint, 0.0)  # avoid 0 * -inf
    h_joint = float(-np.sum(pmf * safe_log))
    return entropy_binomial(p1) + entropy_binomial(p2) - h_joint


def gen_trinomial(
    n_rows: int, m: int, i_target: float, rng: Generator
) -> GeneratedPair:
    p1, p2 = trinomial_params_for_mi(i_target, rng)
    sample = rng.multinomial(m, [p1, p2, 1.0 - p1 - p2], size=n_rows)
    x, y = sample[:, 0].astype(np.int64), sample[:, 1].astype(np.int64)
    mi = true_trinomial_mi(m, p1, p2)
    return GeneratedPair(
        x, y, mi, True, True, {"dist": "trinomial", "m": m, "p1": p1, "p2": p2}
    )


def cdunif_true_mi(m: int) -> float:
    return float(np.log(m) - (m - 1) * np.log(2.0) / m)


def gen_cdunif(n_rows: int, m: int, rng: Generator) -> GeneratedPair:
    x = rng.integers(0, m, size=n_rows).astype(np.int64)
    y = rng.uniform(x, x + 2.0).astype(np.float32)
    return GeneratedPair(
        x, y, cdunif_true_mi(m), True, False, {"dist": "cdunif", "m": m}
    )


def decompose(
    pair: GeneratedPair, scheme: str, rng: Generator
) -> tuple[dict, dict]:
    """Split a post-join (X, Y) sample into T_train[K_Y, Y] and
    T_cand[K_X, X] such that the left join exactly recovers (X, Y).

    Returns (train, cand) dicts with uint32 ``key_hashes`` plus raw
    ``values`` arrays ready for :func:`repro_torch.core.sketch.build_sketch`.
    """
    n = len(pair.x)
    if scheme == "keyind":
        raw_keys = np.arange(n, dtype=np.uint32)
        # Shuffle the candidate table so physical order carries no signal.
        perm = rng.permutation(n)
        train_keys, cand_keys = raw_keys, raw_keys[perm]
    elif scheme == "keydep":
        if not pair.x_is_discrete:
            raise ValueError("KeyDep requires a discrete X (paper Section V-A)")
        raw_keys = pair.x.astype(np.uint32)
        train_keys = raw_keys
        # One candidate row per occurrence; aggregation collapses them
        # (all equal): many-to-one after GROUP BY.
        perm = rng.permutation(n)
        cand_keys = raw_keys[perm]
    else:
        raise ValueError(f"unknown decomposition {scheme!r}")
    seed = np.uint32(_KEY_SEED)
    train = {
        "key_hashes": hashing.murmur3_32_np(train_keys, seed=seed),
        "values": pair.y,
        "value_is_discrete": pair.y_is_discrete,
    }
    cand = {
        "key_hashes": hashing.murmur3_32_np(cand_keys, seed=seed),
        "values": pair.x[perm],
        "value_is_discrete": pair.x_is_discrete,
    }
    return train, cand
