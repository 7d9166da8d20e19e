"""Color palette helpers (css hex conversion, seeded random palettes).

Counterpart of `fusion3dseg_tpu/utils/palette.py` (NumPy only, the same tables).

Mirrors the reference's inline color utilities: css hex formatting
(get3DSeg.py:271-274), random class palettes (get3DSeg.py:259-260) and
per-id panoptic palettes (get3DSeg.py:331).
"""

from __future__ import annotations

import numpy as np


def to_css_hex(color255) -> str:
    """[3] int 0-255 -> '#rrggbb' (reference tocss, get3DSeg.py:271-274)."""
    return "#" + "".join(f"{int(c) & 0xFF:02x}" for c in color255)


def from_css_hex(hex_color: str) -> tuple:
    """'#rrggbb' -> (r, g, b) ints (reference door_window_bbox.py:21-23)."""
    h = hex_color.lstrip("#")
    return tuple(int(h[i : i + 2], 16) for i in (0, 2, 4))


def random_palette(n: int, seed: int = 0, append_black: bool = False) -> np.ndarray:
    """[n(,+1), 3] float palette in [0,1]; seeded for determinism (the
    reference uses the global np.random state, get3DSeg.py:259)."""
    rng = np.random.default_rng(seed)
    pal = rng.uniform(0, 1, size=(n, 3))
    if append_black:
        pal = np.vstack([pal, np.zeros((1, 3))])
    return pal
