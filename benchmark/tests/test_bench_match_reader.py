"""The reader of the engine's match kernel (`scan.fusion_match_ms_per_frame`)
on synthetic traces: the kernel's device time per frame where its launches
equal the program's count of kernel-matched frames, and None where they do
not or where the program counts none (as a program without the kernel)."""

import pytest
from conftest import BENCH

from f3sbench import core

NAME = "void (anonymous namespace)::match_pixels_kernel(const float *, const int *, ...)"


def _reader():
    return core.load_module(BENCH / "metrics" / "scan.fusion_match_ms_per_frame.py",
                            "match_scan_fusion_match_ms_per_frame")


def _traced(launches, counted, seconds=0.0042, frames=300):
    kernels = {"void at::native::vectorized_elementwise_kernel<4>(...)": [9000, 0.2]}
    if launches:
        kernels[NAME] = [launches, seconds]
    stages = {"fuse_vote": 1.2, "fuse_graph.frames": 299.0}
    if counted is not None:
        stages["fuse_match.kernel_frames"] = float(counted)
    return {"trace": {"kernels": kernels, "work": {"frames": frames, "stages": stages}}}


def test_reads_the_kernel_per_frame():
    assert _reader().read(_traced(299, 299)) == pytest.approx(1e3 * 0.0042 / 300)


@pytest.mark.parametrize("launches,counted", [(298, 299), (598, 299), (0, 299), (299, None),
                                              (0, 0)],
                         ids=["missing_launch", "other_calls", "no_kernel", "parent", "cpu"])
def test_none_unless_launches_equal_the_count(launches, counted):
    assert _reader().read(_traced(launches, counted)) is None


def test_untraced_run_reads_none():
    assert _reader().read({"trace": None}) is None
