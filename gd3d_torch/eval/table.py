"""Result tables without pandas: what gd3d's eval returns as DataFrames.

`Table.to_csv` writes the file `DataFrame.to_csv` writes for gd3d's tables:
the index column first under its name, then the columns in order, floats
as Python's repr (pandas' default), NaN as an empty field.
"""
from __future__ import annotations

import csv
import math
from typing import Dict, List, Sequence


class Table:
    def __init__(self, index_name: str, index: Sequence, columns: Dict[str, Sequence[float]]):
        self.index_name = index_name
        self.index = list(index)
        self.columns: Dict[str, List[float]] = {k: [float(v) for v in vals]
                                                for k, vals in columns.items()}
        for k, vals in self.columns.items():
            if len(vals) != len(self.index):
                raise ValueError(f"column {k!r} has {len(vals)} rows, the index {len(self.index)}")

    @classmethod
    def from_rows(cls, rows: Sequence[Dict], index_name: str) -> "Table":
        """DataFrame(rows).set_index(index_name): the columns in the first
        row's key order, less the index."""
        keys = [k for k in rows[0] if k != index_name] if rows else []
        return cls(index_name, [r[index_name] for r in rows],
                   {k: [r[k] for r in rows] for k in keys})

    def header(self) -> List[str]:
        return [self.index_name, *self.columns]

    def mean(self) -> Dict[str, float]:
        """Each column's mean over its non-NaN values (DataFrame.mean)."""
        out = {}
        for k, vals in self.columns.items():
            live = [v for v in vals if not math.isnan(v)]
            out[k] = sum(live) / len(live) if live else math.nan
        return out

    def to_csv(self, path) -> None:
        def cell(v):
            if isinstance(v, float):
                return "" if math.isnan(v) else repr(v)
            return str(v)

        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.header())
            for i, idx in enumerate(self.index):
                w.writerow([cell(idx), *(cell(vals[i]) for vals in self.columns.values())])
