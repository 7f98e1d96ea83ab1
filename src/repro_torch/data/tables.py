"""A minimal columnar table abstraction for the discovery/augmentation layer.

This is deliberately small: the discovery engine only needs (key column,
value column) pairs with type metadata, which mirrors the paper's
two-column table decomposition of real repositories (Section V-C).  Type
inference follows the paper's simplification: ``DISCRETE`` for
string/categorical data, ``CONTINUOUS`` for numeric data.
"""

from __future__ import annotations

import csv
import enum
from dataclasses import dataclass, field
from typing import Iterator, Mapping, Sequence

import numpy as np

from repro_torch.core import hashing

__all__ = ["ColumnType", "Column", "Table"]


class ColumnType(enum.Enum):
    DISCRETE = "discrete"      # unordered categorical (strings, ids)
    CONTINUOUS = "continuous"  # ordered numerical (ints/floats)

    @staticmethod
    def infer(values: np.ndarray) -> "ColumnType":
        if np.issubdtype(np.asarray(values).dtype, np.number):
            return ColumnType.CONTINUOUS
        return ColumnType.DISCRETE


@dataclass
class Column:
    """A named, typed column.

    ``data`` is the raw numpy array.  ``codes`` lazily materializes a
    uint32 representation: murmur3 codes for strings (collision-free in
    the paper's h sense), raw bit patterns are *not* used for floats —
    continuous values stay as float32 and are only hashed when used as a
    join key.
    """

    name: str
    data: np.ndarray
    ctype: ColumnType = None  # type: ignore[assignment]
    _codes: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.data = np.asarray(self.data)
        if self.ctype is None:
            self.ctype = ColumnType.infer(self.data)

    def __len__(self) -> int:
        return len(self.data)

    @property
    def is_discrete(self) -> bool:
        return self.ctype == ColumnType.DISCRETE

    def key_codes(self, seed: int = 0) -> np.ndarray:
        """uint32 codes suitable for use as a join key (h in the paper)."""
        if self._codes is None:
            if self.is_discrete:
                self._codes = hashing.hash_strings(self.data, seed)
            else:
                # Numeric keys: integral values canonicalize to int64 so 3
                # and 3.0 collide (equi-join semantics); non-integral floats
                # hash their float64 bit pattern to preserve distinctness.
                arr = np.asarray(self.data)
                if np.issubdtype(arr.dtype, np.floating) and not np.all(
                    arr == np.floor(arr)
                ):
                    as_int = arr.astype(np.float64).view(np.int64)
                else:
                    as_int = arr.astype(np.int64)
                lo = (as_int & 0xFFFFFFFF).astype(np.uint32)
                hi = ((as_int >> 32) & 0xFFFFFFFF).astype(np.uint32)
                self._codes = hashing.murmur3_32_np(lo, seed=hi)
        return self._codes

    def value_array(self) -> np.ndarray:
        """Value representation fed to MI estimators.

        Continuous -> float32 values; discrete -> uint32 hash codes
        viewed as float32-safe int codes (estimators only use equality
        on discrete values, so hashing is lossless for MI up to 32-bit
        collisions, mirroring the paper's use of h).
        """
        if self.is_discrete:
            return self.key_codes().astype(np.int64)
        return np.asarray(self.data, dtype=np.float32)


class Table:
    """A named collection of columns of equal length."""

    def __init__(self, name: str, columns: Mapping[str, np.ndarray] | Sequence[Column]):
        self.name = name
        if isinstance(columns, Mapping):
            self.columns = {k: Column(k, np.asarray(v)) for k, v in columns.items()}
        else:
            self.columns = {c.name: c for c in columns}
        lengths = {len(c) for c in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged table {name!r}: column lengths {lengths}")
        self.num_rows = lengths.pop() if lengths else 0

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def column_names(self) -> list[str]:
        return list(self.columns)

    def pairs(self, key: str) -> Iterator[tuple[str, str]]:
        """All (key, value) two-column projections, paper Section V-C."""
        for v in self.columns:
            if v != key:
                yield key, v

    @staticmethod
    def from_csv(name: str, path: str) -> "Table":
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = list(reader)
        cols: dict[str, np.ndarray] = {}
        for i, col_name in enumerate(header):
            raw = [r[i] for r in rows]
            try:
                cols[col_name] = np.asarray([float(x) for x in raw], dtype=np.float32)
            except ValueError:
                cols[col_name] = np.asarray(raw)
        return Table(name, cols)
