"""Inputs of the pixel-match tests (`fusion._match_pixels`), shared by the
CPU tests against the JAX package and the card's kernel tests: NumPy
arrays (grid, slotg, fpts, fnrm, fvalid) in the layouts the engine passes."""

import numpy as np

RADIUS, MIN_COS = 0.08, -0.5


def random_case(rng, height, width, half):
    """Candidates near the pixels, a third of them absent, a tenth of the
    pixels invalid, and cells whose two candidates are equal (argmin's
    tie rule: the first in candidate-major order)."""
    gh, gw = -(-height // half), -(-width // half)
    grid = (rng.normal(size=(gh, gw, 12)) * 0.05).astype(np.float32)
    twins = rng.random((gh, gw)) < 0.2
    grid[twins, 6:] = grid[twins, :6]
    slotg = rng.integers(0, 1 << 15, size=(gh, gw, 2)).astype(np.int32)
    slotg[rng.random((gh, gw, 2)) < 0.3] = -1
    P = height * width
    fpts = (rng.normal(size=(P, 3)) * 0.05).astype(np.float32)
    fnrm = rng.normal(size=(P, 3)).astype(np.float32)
    fvalid = rng.random(P) < 0.9
    return grid, slotg, fpts, fnrm, fvalid


def boundary_case(rng, height, width, half):
    """Every pixel at the origin with normal (1, 0, 0); each candidate one
    axis-aligned step away, so its distance is |x| and its cosine the first
    component of its normal, exactly. Steps and cosines are drawn from
    float32 values on, just below and just above `RADIUS` and `MIN_COS`:
    limits met exactly, and many equal distances among a pixel's 18."""
    gh, gw = -(-height // half), -(-width // half)
    r, c = np.float32(RADIUS), np.float32(MIN_COS)
    steps = np.array([np.nextafter(r, 0), r, np.nextafter(r, 1), r / 2], np.float32)
    coss = np.array([np.nextafter(c, -1), c, np.nextafter(c, 1), 1.0], np.float32)
    grid = np.zeros((gh, gw, 2, 6), np.float32)
    axis = rng.integers(0, 3, size=(gh, gw, 2))
    sign = rng.choice(np.array([-1, 1], np.float32), size=(gh, gw, 2))
    step = steps[rng.integers(0, len(steps), size=(gh, gw, 2))]
    np.put_along_axis(grid[..., :3], axis[..., None], (sign * step)[..., None], axis=-1)
    grid[..., 3] = coss[rng.integers(0, len(coss), size=(gh, gw, 2))]
    slotg = rng.integers(0, 1 << 15, size=(gh, gw, 2)).astype(np.int32)
    slotg[rng.random((gh, gw, 2)) < 0.1] = -1
    P = height * width
    fnrm = np.tile(np.float32([1, 0, 0]), (P, 1))
    return (grid.reshape(gh, gw, 12), slotg, np.zeros((P, 3), np.float32), fnrm,
            rng.random(P) < 0.95)


CASES = {"random_ties": random_case, "boundaries": boundary_case}
