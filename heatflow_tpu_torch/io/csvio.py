"""CSV output in the reference's exact formats, written with the ``csv``
module to the bytes pandas' ``to_csv`` writes (numbers as numpy prints
them, NaN as an empty field, '\n' line ends).

Two conventions coexist in the reference, and the downstream pipeline reads
both (SURVEY.md §7):

* ``watcher_points.csv`` — a ``time`` *column* plus one column per watcher
  (ref run_no_diamond.py:594-600);
* ``radial_gradient[_raw].csv`` — time as the *index*, named ``time``, and
  the z positions as columns (ref :602-617).
"""

from __future__ import annotations

import csv

import numpy as np


def _text(v) -> str:
    """A table cell as pandas writes it: numpy's shortest round-trip text of
    the value in its own dtype, '' for NaN and None."""
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if not isinstance(v, np.floating):
        v = np.float64(v)
    return "" if np.isnan(v) else str(v)


def write_rows(path: str, header: list, rows) -> None:
    """``header`` then ``rows`` (iterables of cells), as pandas writes a
    frame: minimal quoting, '\n' line ends."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([_text(h) for h in header])
        w.writerows([_text(v) for v in row] for row in rows)


def write_watcher_csv(path: str, times: np.ndarray,
                      traces: dict[str, np.ndarray]) -> None:
    cols = [np.asarray(times)] + [np.asarray(v) for v in traces.values()]
    write_rows(path, ["time", *traces], zip(*cols))


def write_gradient_csv(path: str, times: np.ndarray, columns: np.ndarray,
                       rows: np.ndarray) -> None:
    """rows: (n_times, n_columns); columns are z positions (floats)."""
    rows = np.asarray(rows)
    write_rows(path, ["time", *np.asarray(columns)],
               ([t, *row] for t, row in zip(np.asarray(times), rows)))


def write_records(path: str, records: list[dict]) -> None:
    """Dicts as rows, the union of their keys (in first-seen order) as the
    header; a missing key is an empty field."""
    keys = list(dict.fromkeys(k for rec in records for k in rec))
    write_rows(path, keys, ([rec.get(k) for k in keys] for rec in records))


def read_records(path: str) -> list[dict]:
    """The rows of a CSV as dicts, with numbers parsed back (int, else
    float) and empty fields as None."""
    def value(text):
        if text == "":
            return None
        for cast in (int, float):
            try:
                return cast(text)
            except ValueError:
                pass
        return text

    with open(path, newline="") as f:
        return [{k: value(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def read_watcher_csv(path: str) -> dict[str, np.ndarray]:
    """The columns of a watcher CSV by name (``time`` first), as float64."""
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    vals = np.array([[float(v) if v else np.nan for v in row]
                     for row in body], dtype=np.float64).reshape(
        len(body), len(header))
    return {name: vals[:, k] for k, name in enumerate(header)}


def read_gradient_csv(path: str):
    """Return (times (T,), z_positions (Z,), values (T, Z)) — the parsing the
    1D driver and the plotting layer rely on (ref run_no_diamond_1d.py:348-351,
    plot_radial_gradient.py:43-63)."""
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    z = np.array([float(v) for v in header[1:]], dtype=np.float64)
    vals = np.array([[float(v) if v else np.nan for v in row]
                     for row in body], dtype=np.float64).reshape(
        len(body), len(header))
    return vals[:, 0], z, vals[:, 1:]
