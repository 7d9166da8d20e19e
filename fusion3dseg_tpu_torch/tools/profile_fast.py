"""Where the time of the main path goes on the card.

    python -m fusion3dseg_tpu_torch.tools.profile_fast [--frames F] [--hw H W]

Builds the synthetic 48-frame 256x192 session (`io/synthetic.make_session`,
the room of seed 0) on the card and runs `segment_session_fast` on its
ground-truth masks with the main path's settings (radius 0.05, angle 10,
capacity 2^17, auto window, split policy, 133 classes). One warm-up call,
three timed calls without the profiler (their median is the wall time the
busy share is taken against), then one call under `torch.profiler`.
Prints the stage times, the device kernel time by name, the launches a
frame and the device's busy share. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fusion3dseg_tpu_torch.io import synthetic
from fusion3dseg_tpu_torch.io.rtab import SessionData
from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast
from fusion3dseg_tpu_torch.tools.profiling import card_line, profile_run

MAIN_PATH = dict(radius=0.05, angle=10.0, max_depth=8.0, capacity=1 << 17, window="auto",
                 window_policy="split", nclasses=133, threshold=0.5, min_pts_per_inst=100)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 192))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sess = synthetic.make_session(nframes=args.frames, depth_hw=tuple(args.hw))
    sd = SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                 sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                 device="cuda")
    masks = torch.as_tensor(sess.gt_mask.reshape(args.frames, -1), device="cuda")

    def run():
        return segment_session_fast(sd, masks=masks, device="cuda", **MAIN_PATH)

    res = run()  # warm-up: allocations, plans, the native library's build
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    print(f"card: {card_line()}")
    print(f"segment_session_fast: {args.frames} frames at {args.hw[0]}x{args.hw[1]}, n {res.n}, "
          f"{len(res.instance_info)} instances, overflow frames {res.overflow_frames}; wall "
          f"{[round(w, 4) for w in walls]} s, median {wall:.4f} s "
          f"({args.frames / wall:.1f} frames/s); stages (last call) "
          + ", ".join(f"{k} {v:.4f} s" for k, v in res.stage_seconds.items()))
    stats = profile_run(run, f"segment_session_fast, {args.frames} frames")
    print(f"launches a frame {stats['launches'] / args.frames:.1f}; device busy share "
          f"against the unprofiled median wall {stats['device_s'] / wall:.3f}")


if __name__ == "__main__":
    main()
