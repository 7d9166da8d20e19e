"""Shared by the benchmark's CPU tests: the harness and the program on the
path, and each cell's traffic cut to a size a CPU test can hold."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tools")]

# traffic (and configuration) values that cut each cell to a few frames of a
# small image; the cells' shapes of work stay as they are
TINY = {
    "scan-masks-tum640": {"frames": 10, "hw": [60, 80],
                          "intrinsics": [64.66, 64.56, 39.8, 31.9], "capacity": 131072},
    "scan-b2-tum640": {"frames": 8, "hw": [60, 80], "intrinsics": [64.66, 64.56, 39.8, 31.9],
                       "capacity": 131072},
    "relabel-1m-300f": {"npts": 20000, "frames": 8, "hw": [64, 48], "cell_size": 64},
}


def tiny_cell(name: str, limits=None):
    """(spec, cell, config, traffic, driver) of `name` at its tiny size."""
    from f3sbench import core

    spec, cell, config, traffic, driver = core.load_cell(name)
    for k, v in TINY[name].items():
        (config if k in config else traffic)[k] = v
    if "segmenter" in config:
        config["segmenter"]["input_hw"] = [64, 64]
    if limits:
        traffic["limits"][config["name"]].update(limits)
    return spec, cell, config, traffic, driver


@pytest.fixture(autouse=True)
def _one_thread():
    """The program's many small CPU ops run on one thread beside other test
    workers (OpenMP regions stall when their threads are descheduled)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
