"""Long-session soak: the counterpart of `examples/soak_long_session.py`.

    python -m fusion3dseg_tpu_torch.tools.soak [--frames 2048] [--ckpt-dir DIR] [--device cuda]

A multi-thousand-frame synthetic session (128x96, four turns, so that the
trajectory closes its loop again and again) through
`fusion.fuse_session_checkpointed` at capacity 2^20, radius 0.05, 10
degrees, max depth 8, 128 frames a chunk, with the auto window from the
seed frame's occupied cells. The run stops after half its chunks (a
"crash"), a fresh call resumes it from the checkpoint, and an uninterrupted
checkpointed run follows. It checks the int32 counters over thousands of
frames, the auto window at loop closure, and that the resumed state and
uv2pt equal the uninterrupted run's bit for bit.

Prints one JSON line with the example's keys, plus `device` (the card's
name and power limit, as nvidia-smi gives them, or "cpu"). Its times are
that device's. Without `--ckpt-dir` the checkpoints go to a temporary
directory that is removed afterwards.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.fusion import fusion as fusion_engine
from fusion3dseg_tpu_torch.io import synthetic
from fusion3dseg_tpu_torch.io.rtab import SessionData
from fusion3dseg_tpu_torch.tools.profiling import device_line

HW = (128, 96)


class Soak(NamedTuple):
    result: dict  # the JSON line's keys
    state: fusion_engine.FusionState  # the resumed run's final state
    uv2pt: np.ndarray  # the resumed run's [frames, H*W] int32
    args: tuple  # the session arrays `fuse_session` takes
    kw: dict  # and its keyword arguments (device included)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def soak(frames: int = 2048, ckpt_dir=None, device="cuda", *, capacity: int = 1 << 20,
         chunk_frames: int = 128, verbose: bool = False) -> Soak:
    """The soak on `device`. `capacity` and `chunk_frames` are the example's
    unless a test shrinks them."""
    dev = cuda.resolve_device(device)
    root = Path(ckpt_dir) if ckpt_dir else Path(tempfile.mkdtemp())
    h, w = HW
    try:
        t0 = time.perf_counter()
        sess = synthetic.make_session(nframes=frames, depth_hw=HW, turns=4.0,
                                      room=synthetic.RoomSpec(seed=11, num_objects=10))
        sd = SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                     sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                     device=dev)
        valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
        if verbose:
            _log(f"generated {frames} frames at {h}x{w} in {time.perf_counter() - t0:.1f} s")
        radius, min_cosine = 0.05, float(np.cos(np.deg2rad(10.0)))
        seed_cells = fusion_engine.seed_cells_for_frame(sd.points[0], sd.normals[0],
                                                        sd.colors[0], valid[0], h, w, radius,
                                                        min_cosine)
        window = fusion_engine.auto_window(seed_cells, capacity)
        if verbose:
            _log(f"auto window: seed {seed_cells} cells -> {window}")
        args = (sd.Ks.astype(np.float32), sd.quats_wxyz, sd.translations, sd.points,
                sd.normals, sd.colors, valid)
        kw = dict(height=h, width=w, radius=radius, min_cosine=min_cosine, max_depth=8.0,
                  capacity=capacity, window=window, device=dev)
        run = dict(chunk_frames=chunk_frames, verbose=verbose, **kw)

        # interrupted after half the chunks, then resumed by a fresh call
        crash = max(1, -(-(frames - 1) // chunk_frames) // 2)
        interrupted = root / "interrupted"
        t0 = time.perf_counter()
        st_half, _ = fusion_engine.fuse_session_checkpointed(
            *args, ckpt_dir=interrupted, max_chunks=crash, **run)
        n_half = int(st_half.n)
        if verbose:
            _log(f"first {crash} chunks: {time.perf_counter() - t0:.1f} s, n={n_half}")
        t0 = time.perf_counter()
        st_resumed, uv_resumed = fusion_engine.fuse_session_checkpointed(
            *args, ckpt_dir=interrupted, **run)
        if verbose:
            _log(f"resumed remainder: {time.perf_counter() - t0:.1f} s")

        # the uninterrupted checkpointed run
        t0 = time.perf_counter()
        st_full, uv_full = fusion_engine.fuse_session_checkpointed(
            *args, ckpt_dir=root / "oneshot", **dict(run, verbose=False))
        t_full = time.perf_counter() - t0
    finally:
        if not ckpt_dir:
            shutil.rmtree(root, ignore_errors=True)

    n = int(st_full.n)
    eq_state = bool(torch.equal(st_resumed.points, st_full.points)
                    and torch.equal(st_resumed.nmerges, st_full.nmerges)
                    and torch.equal(st_resumed.occurences, st_full.occurences)
                    and int(st_resumed.n) == n)
    result = {
        "frames": frames,
        "points": n,
        "capacity": capacity,
        "window": window,
        "soak_fps": (frames - 1) / t_full,
        "full_run_seconds": t_full,
        "resume_equals_oneshot_state": eq_state,
        "resume_equals_oneshot_uv2pt": bool(np.array_equal(uv_resumed, uv_full)),
        "max_nmerges": int(st_full.nmerges.max()),
        "saturated": n >= capacity,
        "interrupted_at_points": n_half,
        "device": device_line(dev),
    }
    return Soak(result, st_resumed, uv_resumed, args, kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = soak(args.frames, args.ckpt_dir, args.device, verbose=True)
    print(json.dumps(run.result), flush=True)


if __name__ == "__main__":
    main()
