"""Stage artifacts on disk.

Counterpart of the part of `fusion3dseg_tpu/io/artifacts.py` that the
in-memory pipeline writes: the instance info JSON. The fusion dumps, the
uv2pt files and the readers come with the file-artifact slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _clean(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, dict):
        return {k: _clean(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_clean(v) for v in o]
    return o


def write_info_json(path, info) -> None:
    """Write per-instance info dicts as indented JSON (NumPy scalars and
    arrays as plain numbers and lists), creating the directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fp:
        json.dump(_clean(info), fp, indent=4)
