"""One run of one cell of the port's benchmark.

A cell is an entry of `workloads` in `BENCHMARK.json`: a configuration (its
file under `benchmark/configs/`) under a traffic mix (the data file
`benchmark/traffic/<traffic>.json`, whose `driver` names the generator and
request loop in `benchmark/drivers/<driver>.py`). Per-layer metrics are
readers in `benchmark/metrics/<name>.py`. All of them are found by name, so
a cell, a mix or a metric is added by adding files and entries.

A run: set-up (inputs and weights from the seed, warm-up), a window of
whole requests, closed loop, until `--seconds` have passed, then (with
`--trace 1`) one more request under the profiler, then the program's state
is freed and the kept answers are held to the plain reference. The last
line of standard output is the result; the compared numbers, each beside
its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "fusion3dseg_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def process_start() -> float:
    """Seconds since boot at which this process started (/proc/self/stat)."""
    stat = Path("/proc/self/stat").read_text()
    ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    return ticks / os.sysconf("SC_CLK_TCK")


def since_boot() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json", bench: Path = BENCH):
    """(spec, cell entry, configuration, traffic, driver module) of a cell."""
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((spec_path.parent / cfg_entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = load_module(bench / "drivers" / f"{traffic['driver']}.py",
                         f"f3sbench_driver_{traffic['driver']}")
    return spec, cell, config, traffic, driver


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: end-to-end ones without
    `--trace`, per-layer ones with it."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


class Ctx:
    """What a driver gets: the run's arguments, its cell's data, a device."""

    def __init__(self, cell, config, traffic, seed, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, device


def run_cell(spec, cell, config, traffic, driver, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench: Path = BENCH) -> dict:
    """Set-up, window, optional traced request, check. Returns the result
    dict (without the import guard, which the caller applies)."""
    import torch

    from f3sbench import trace as tracing

    cuda = torch.device(device).type == "cuda"
    ctx = Ctx(cell, config, traffic, seed, torch.device(device))
    state = driver.setup(ctx)
    log(f"set-up: inputs ready at {since_boot() - t_start:.3f} s")
    driver.warmup(state)
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    setup_s = since_boot() - t_start

    records = []
    i = 0
    pauses = GcPauses()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        info = driver.request(state, i, keep=driver.keeps(state, i))
        te = time.perf_counter()
        records.append({"start": ts, "end": te, **info})
        i += 1
        if te - t0 >= seconds:
            break
    pauses.stop()
    window_s = records[-1]["end"] - records[0]["start"]
    took = sorted(r["end"] - r["start"] for r in records)
    log(f"window: {len(records)} requests in {window_s:.3f} s; a request took "
        f"{took[0]:.4f} / {took[len(took) // 2]:.4f} / {took[-1]:.4f} s (min / median / max); "
        f"set-up {setup_s:.3f} s; garbage collection {pauses.seconds:.4f} s in "
        f"{pauses.count} passes")
    stages = sorted({k for r in records for k in r.get("stages", {})})
    for k in stages:
        v = sorted(r["stages"][k] for r in records if k in r["stages"])
        log(f"stage {k}: {v[0]:.4f} / {v[len(v) // 2]:.4f} / {v[-1]:.4f} s "
            f"(min / median / max)")
    log("requests (input, seconds, size): " + " ".join(
        f"{r.get('key')}:{r['end'] - r['start']:.3f}:{r.get('n', '')}" for r in records))

    traced = None
    if trace:
        with tracing.profiled(cuda) as traced:
            info = driver.request(state, i, keep=False)
        traced["work"] = info
        log(f"traced request: {traced['window_s']:.3f} s, busy {traced['busy_s']:.3f} s, "
            f"{traced['launches']} launches")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    driver.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(state)

    rec = {"cell": cell["name"], "config": config, "traffic": traffic, "requests": records,
           "window_s": window_s, "trace": traced}
    metrics = {}
    for m in cell_metrics(spec, cell["name"], trace):
        if m["name"] == "setup_s":
            value = setup_s
        elif not trace:
            value = driver.end_to_end(rec).get(m["name"])
        else:
            reader = load_module(bench / "metrics" / f"{m['name']}.py",
                                 "f3sbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(checks) and all(c["value"] <= c["limit"] for c in checks),
           "attempted": len(records), "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


class GcPauses:
    """Seconds that Python's garbage collector ran, from now to `stop`."""

    def __init__(self):
        self.seconds, self.count, self._t = 0.0, 0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count += 1
            self._t = None

    def stop(self):
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    # every build and kernel cache of the program at a fixed path in the checkout
    os.environ["F3S_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    spec, cell, config, traffic, driver = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = run_cell(spec, cell, config, traffic, driver, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {', '.join(bad)}")
        return 4
    emit(result)
    return 0
