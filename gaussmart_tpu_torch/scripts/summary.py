#!/usr/bin/env python3
"""Aggregate per-scene results.json into one table + averages
(reference scripts/summary.py:7-54; counterpart of scripts/summary.py,
without pandas): one row per (scene, method) with its metrics, the
columns in order of first appearance, and the mean of each numeric
column over the rows that have a number (a null is skipped, as pandas
skips NaN; a column with no number, or with text or booleans, has no
mean).

    python -m gaussmart_tpu_torch.scripts.summary --root <dir of <scene>/results.json>
"""
from __future__ import annotations

import glob
import json
import os
from argparse import ArgumentParser
from numbers import Number

import numpy as np


def collect(root: str):
    """(rows, columns) from <root>/*/results.json."""
    rows = []
    for path in sorted(glob.glob(os.path.join(root, "*", "results.json"))):
        scene = os.path.basename(os.path.dirname(path))
        with open(path) as f:
            res = json.load(f)
        for method, metrics in res.items():
            rows.append({"scene": scene, "method": method, **metrics})
    columns = list(dict.fromkeys(k for r in rows for k in r))
    return rows, columns


def _is_number(v) -> bool:
    return isinstance(v, Number) and not isinstance(v, bool)


def averages(rows, columns):
    """{column: mean} over the numeric columns."""
    out = {}
    for c in columns:
        vals = [r.get(c) for r in rows]
        nums = [v for v in vals if _is_number(v)]
        if nums and all(v is None or _is_number(v) for v in vals):
            out[c] = float(np.mean(np.asarray(nums, np.float64)))
    return out


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--root", default=".",
                        help="directory containing <scene>/results.json")
    args = parser.parse_args(argv)

    rows, columns = collect(args.root)
    if not rows:
        print("no results.json found under", args.root)
        return
    cells = [[("" if r.get(c) is None else str(r.get(c))) for c in columns] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(columns)]
    print("  ".join(c.rjust(w) for c, w in zip(columns, widths)))
    for row in cells:
        print("  ".join(v.rjust(w) for v, w in zip(row, widths)))
    print("\naverages:")
    means = averages(rows, columns)
    width = max(map(len, means), default=0)
    for c, m in means.items():
        print(f"{c.ljust(width)}  {m}")
    return rows, means


if __name__ == "__main__":
    main()
