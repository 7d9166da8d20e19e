"""Readings from which a cell's limits are set: for each seed, the numbers
that the program's answers give against the plain reference (the lower
reading), and those that the control gives (the reference computed one
precision step below the configuration's, in the program's place: the
upper reading). One process, a short run of requests a seed: as many as a
run compares, at the cell's own sizes.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1,2,3 [--out FILE]
        [--no-control]

Prints one JSON line per seed and writes them to --out when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]

from f3sbench import core  # noqa: E402


def readings(cell: str, seeds, device: str = "cuda", overrides=None, log=core.log,
             with_control: bool = True):
    """[{"seed", "program": {number: value}, "control": {...}}] for `seeds`
    ("control" empty without `with_control`)."""
    import torch

    spec, entry, config, traffic, driver = core.load_cell(cell)
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = core.Ctx(entry, config, traffic, seed, torch.device(device))
        st = driver.setup(ctx)
        for i in range(max(st.sample) + 1):
            driver.request(st, i, keep=driver.keeps(st, i))
        driver.release(st)
        prog, ctrl = {}, {}
        for i, got in sorted(st.kept.items()):
            ref = driver.reference(st, driver.key(st, i))
            for name, v in driver.compare(got, ref).items():
                prog[name] = max(prog.get(name, v), v)
            if not with_control:
                continue
            low = driver.reference(st, driver.key(st, i), control=True)
            for name, v in driver.compare(low, ref).items():
                ctrl[name] = max(ctrl.get(name, v), v)
        row = {"cell": cell, "seed": seed, "program": prog, "control": ctrl,
               "seconds": time.perf_counter() - t0}
        log(json.dumps(row))
        out.append(row)
        del st
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--no-control", action="store_true",
                    help="the program's readings alone")
    args = ap.parse_args()
    os.environ.setdefault("F3S_TORCH_BUILD_DIR", str(core.ROOT / "build"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    with_control=not args.no_control)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
