"""A minimal labeled 2-D table for the cohort path (no pandas).

The JAX package's host pipeline holds the omics matrices in pandas
DataFrames (data/cohort.py, data/loaders.py); the port's hosts may have no
pandas, so ``Frame`` keeps what that path uses, each with pandas' meaning:

- string row labels (``index``), string column labels (``columns``) and a
  float64 value matrix, NaN for a missing value;
- ``reindex`` (rows not present become NaN rows), ``select`` (columns by
  label, in the given order);
- ``mean`` / ``std`` per column, skipping NaN, ``std`` with ddof = 1,
  summed the way pandas' nanops sum a contiguous column (numpy's pairwise
  sum), so they agree with pandas to the last bit;
- ``quantile`` per column (linear interpolation, NaN skipped), ``clip``
  per column, arithmetic with a per-column vector;
- ``drop_na_line`` (data/loaders.py:30).

``KeggTable`` holds the KEGG gene table.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np


class Frame:
    def __init__(self, values: np.ndarray, index: Sequence[str], columns: Sequence[str]):
        values = np.asarray(values, np.float64)
        if values.shape != (len(index), len(columns)):
            raise ValueError(f"values {values.shape} vs {len(index)} x {len(columns)} labels")
        self.values = values
        self.index = [str(i) for i in index]
        self.columns = [str(c) for c in columns]
        self._row_pos: Optional[Dict[str, int]] = None
        self._col_pos: Optional[Dict[str, int]] = None

    def row_pos(self) -> Dict[str, int]:
        """label -> row; a repeated label maps to its first row."""
        if self._row_pos is None:
            pos: Dict[str, int] = {}
            for i, p in enumerate(self.index):
                pos.setdefault(p, i)
            self._row_pos = pos
        return self._row_pos

    def col_pos(self) -> Dict[str, int]:
        if self._col_pos is None:
            pos: Dict[str, int] = {}
            for i, c in enumerate(self.columns):
                pos.setdefault(c, i)
            self._col_pos = pos
        return self._col_pos

    def has_row(self, label) -> bool:
        return str(label) in self.row_pos()

    def has_col(self, label) -> bool:
        return str(label) in self.col_pos()

    def reindex(self, rows: Sequence[str]) -> "Frame":
        """Rows in the given order; a label not present gives a NaN row."""
        pos = self.row_pos()
        idx = np.array([pos.get(str(r), -1) for r in rows], np.int64)
        out = np.full((len(idx), self.values.shape[1]), np.nan)
        hit = idx >= 0
        out[hit] = self.values[idx[hit]]
        return Frame(out, rows, self.columns)

    def select(self, cols: Sequence[str]) -> "Frame":
        """Columns by label, in the given order; a missing label raises."""
        pos = self.col_pos()
        missing = [c for c in cols if str(c) not in pos]
        if missing:
            raise KeyError(f"columns not in the frame: {missing[:5]}")
        idx = [pos[str(c)] for c in cols]
        return Frame(self.values[:, idx], self.index, cols)

    def rename_columns(self, mapping: Dict[str, str]) -> "Frame":
        return Frame(self.values, self.index, [mapping.get(c, c) for c in self.columns])

    def _columns_contiguous(self):
        colT = np.ascontiguousarray(self.values.T)
        nan = np.isnan(colT)
        return np.where(nan, 0.0, colT), nan, (~nan).sum(axis=1)

    def mean(self) -> np.ndarray:
        """Per-column mean skipping NaN (NaN for an all-NaN column)."""
        filled, _, count = self._columns_contiguous()
        with np.errstate(invalid="ignore", divide="ignore"):
            out = filled.sum(axis=1) / count
        return np.where(count > 0, out, np.nan)

    def std(self) -> np.ndarray:
        """Per-column sample standard deviation (ddof = 1) skipping NaN."""
        filled, nan, count = self._columns_contiguous()
        with np.errstate(invalid="ignore", divide="ignore"):
            avg = filled.sum(axis=1) / count
            sqr = np.where(nan, 0.0, (avg[:, None] - filled) ** 2)
            var = sqr.sum(axis=1) / (count - 1)
        return np.where(count > 1, np.sqrt(var), np.nan)

    def quantile(self, q: float) -> np.ndarray:
        """Per-column q-quantile, linear interpolation, NaN skipped."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN column
            return np.nanquantile(self.values, q, axis=0)

    def clip(self, lower: np.ndarray, upper: np.ndarray) -> "Frame":
        """Clip each column to [lower[c], upper[c]]; NaN stays NaN."""
        return Frame(
            np.minimum(np.maximum(self.values, lower[None]), upper[None]),
            self.index, self.columns,
        )

    def sub_cols(self, v: np.ndarray) -> "Frame":
        return Frame(self.values - v[None], self.index, self.columns)

    def div_cols(self, v: np.ndarray) -> "Frame":
        return Frame(self.values / v[None], self.index, self.columns)

    def neg(self) -> "Frame":
        return Frame(-self.values, self.index, self.columns)


class KeggTable:
    """The KEGG gene table (columns PathwayID, Symbol, Entrezid), row order
    kept: the cohort path asks it for a pathway's genes, first appearance
    first (pandas' ``unique``)."""

    def __init__(self, pathway: Sequence[str], symbol: Sequence[str], entrez: Sequence[int]):
        if not (len(pathway) == len(symbol) == len(entrez)):
            raise ValueError("KEGG columns differ in length")
        self.pathway = [str(p) for p in pathway]
        self.symbol = [str(s) for s in symbol]
        self.entrez = np.asarray(entrez, np.int64)
        self._by_pathway: Dict[str, Dict[int, None]] = {}
        for p, e in zip(self.pathway, self.entrez.tolist()):
            self._by_pathway.setdefault(p, {}).setdefault(e, None)

    def entrez_of(self, pathway: str) -> np.ndarray:
        """Unique entrez ids of one pathway, in order of first appearance."""
        return np.asarray(list(self._by_pathway.get(str(pathway), {})), np.int64)

    def entrez_in(self, pathways: Sequence[str]) -> np.ndarray:
        """Unique entrez ids of the rows whose pathway is in ``pathways``."""
        want = set(str(p) for p in pathways)
        seen: Dict[int, None] = {}
        for p, e in zip(self.pathway, self.entrez.tolist()):
            if p in want:
                seen.setdefault(e, None)
        return np.asarray(list(seen), np.int64)


def drop_na_line(df: Frame, percent: float = 0.9) -> Frame:
    """Drop rows that are more than percent NaN (reference
    multiloader.py:892-893; data/loaders.py:30)."""
    keep = np.isnan(df.values).sum(axis=1) <= len(df.columns) * percent
    return Frame(df.values[keep], [p for p, k in zip(df.index, keep) if k], df.columns)

