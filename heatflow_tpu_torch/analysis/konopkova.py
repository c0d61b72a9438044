"""Konopkova-dataset support.

The reference ships two headerless two-column CSVs
(experimental_data/konopkova_{pside,oside}.csv: time, temperature) and a
truncated/malformed konopkova.yaml (SURVEY.md §2 'Dead/stale'). This module
converts the raw traces into the standard heating-CSV schema
(time, temp, oside) consumed by every driver, with an explicit time-unit
scale because the raw files are not in seconds. Read and written with the
``csv`` module (no pandas).
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from heatflow_tpu_torch.io.csvio import write_rows


def _number(text: str) -> float:
    try:
        return float(text)
    except ValueError:
        return np.nan


def load_xy_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a headerless two-column (x, y) CSV: rows with a field that is
    not a number are dropped, the rest sorted by x (numpy's quicksort, the
    order pandas' ``sort_values`` gives)."""
    with open(path, newline="") as f:
        rows = [(row + ["", ""])[:2] for row in csv.reader(f) if row]
    xy = np.array([[_number(a), _number(b)] for a, b in rows],
                  dtype=np.float64).reshape(-1, 2)
    xy = xy[~np.isnan(xy).any(axis=1)]
    xy = xy[np.argsort(xy[:, 0], kind="quicksort")]
    return xy[:, 0].copy(), xy[:, 1].copy()


def convert_konopkova(pside_path: str, oside_path: str, out_path: str, *,
                      time_scale: float = 1e-6,
                      temp_scale: float = 1000.0) -> dict[str, np.ndarray]:
    """Merge p-side and o-side traces into the standard schema; returns the
    columns ``time``, ``temp`` and ``oside`` and writes them to
    ``out_path`` (when given).

    time_scale: raw time unit in seconds (the raw data is O(1), consistent
    with microseconds for these experiments).
    temp_scale: raw temperature unit in kelvin (raw values are O(2),
    consistent with kK).

    The o-side trace is linearly interpolated onto the p-side time base.
    """
    tp, Tp = load_xy_csv(pside_path)
    to, To = load_xy_csv(oside_path)
    oside = np.interp(tp, to, To)
    cols = {"time": tp * time_scale, "temp": Tp * temp_scale,
            "oside": oside * temp_scale}
    if out_path:
        write_rows(out_path, list(cols), zip(*cols.values()))
    return cols


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert Konopkova raw traces to the heating-CSV schema")
    p.add_argument("--pside", default="experimental_data/konopkova_pside.csv")
    p.add_argument("--oside", default="experimental_data/konopkova_oside.csv")
    p.add_argument("--out", default="experimental_data/konopkova_heat_data.csv")
    p.add_argument("--time-scale", type=float, default=1e-6)
    p.add_argument("--temp-scale", type=float, default=1000.0)
    args = p.parse_args(argv)
    cols = convert_konopkova(args.pside, args.oside, args.out,
                             time_scale=args.time_scale,
                             temp_scale=args.temp_scale)
    print(f"wrote {args.out}: {len(cols['time'])} rows, "
          f"t in [{cols['time'].min():.3e}, {cols['time'].max():.3e}] s, "
          f"T in [{cols['temp'].min():.1f}, {cols['temp'].max():.1f}] K")


if __name__ == "__main__":
    main()
