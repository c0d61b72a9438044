"""Run metadata writers (ref io_utilities/xdmf_utils.py:29-44)."""

from __future__ import annotations

import os


def save_params(sim_folder: str, params_dict: dict) -> str:
    """Write a ``params.txt`` with one ``key = value`` line per entry."""
    os.makedirs(sim_folder, exist_ok=True)
    path = os.path.join(sim_folder, "params.txt")
    with open(path, "w") as f:
        for key, val in params_dict.items():
            f.write(f"{key} = {val}\n")
    return path
