"""Where the time of the session label lifter goes on the card.

    python -m fusion3dseg_tpu_torch.tools.profile_label_fuse [--id-bits B]

Builds the headline workload (1M points x 300 frames at 256x192, 133
classes), the cell index on the host, and runs the device program of
`tpu_label_fuse_cells` once to warm up and then under `torch.profiler`.
Prints the wall time of the profiled run, the summed device time of its
kernels and their share of the wall time (the device's busy share), and
the kernels by device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fusion3dseg_tpu_torch.io.workload import make_workload
from fusion3dseg_tpu_torch.ops import label_fuse as lf
from fusion3dseg_tpu_torch.tools.profiling import profile_run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--id-bits", type=int, default=20,
                    help="packed id width; below 20 runs the gid-range-sharded z-buffer")
    args = ap.parse_args(argv)
    npts, frames = 1_000_000, 300
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    hw, nclasses = (256, 192), 133
    points, K, quats, trans, masks = make_workload(npts, frames, hw)
    cells_table, cell_lists, counts = lf.build_cell_index(points, K, quats, trans, hw,
                                                          cell_size=128)
    perm, sizes, Ks = lf.plan_window_buckets(counts, nbuckets=12, round_to=8,
                                             max_window=cell_lists.shape[1])
    dev = torch.device("cuda")
    run = lf.tpu_label_fuse_cells(npts, nclasses, hw, Ks, sizes,
                                  id_bits=args.id_bits, device="cuda")
    dev_args = (torch.as_tensor(cells_table, device=dev),
                torch.as_tensor(cell_lists[perm], device=dev),
                torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev),
                torch.as_tensor(quats[perm], device=dev),
                torch.as_tensor(trans[perm], device=dev),
                torch.as_tensor(masks[perm], device=dev))
    run(*dev_args)
    torch.cuda.synchronize()

    profile_run(lambda: run(*dev_args),
                f"{npts} pts x {frames} frames, id_bits {args.id_bits}")


if __name__ == "__main__":
    main()
