"""Solver-state checkpoint / resume: the temperature field and simulated
time at the end of a run, which a later run continues from through the
stepper's ``u0`` / ``t0``. The reference persists only the mesh and config
(SURVEY §5.4)."""

from __future__ import annotations

import os

import numpy as np


def save_checkpoint(folder: str, u: np.ndarray, t: float, *,
                    step: int | None = None, extra: dict | None = None
                    ) -> str:
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "checkpoint.npz")
    payload = {"u": np.asarray(u), "t": float(t),
               "step": -1 if step is None else int(step)}
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    np.savez(path, **payload)
    return path


def load_checkpoint(path: str):
    """Return (u, t, step, extra)."""
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.npz")
    with np.load(path) as z:
        u = z["u"]
        t = float(z["t"])
        step = int(z["step"])
        extra = {k[len("extra_"):]: z[k] for k in z.files
                 if k.startswith("extra_")}
    return u, t, (None if step < 0 else step), extra
