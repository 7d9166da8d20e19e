"""The readers of the program's dispatch and wait spans, on synthetic
records: the mean over the window's sessions, per frame, and None where the
program records no such key (as a program without these spans does)."""

import pytest
from conftest import BENCH

from f3sbench import core


def _reader(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", "span_" + name.replace(".", "_"))


def _rec(*stages, frames=300):
    return {"requests": [{"frames": frames, "stages": s} for s in stages]}


MASKS = [{"fuse_vote": 2.1, "fuse_vote.dispatch": 1.8, "fuse_vote.wait": 0.3, "repair": 0.04},
         {"fuse_vote": 2.4, "fuse_vote.dispatch": 2.1, "fuse_vote.wait": 0.3, "repair": 0.04}]
B2 = [{"fuse": 2.0, "fuse.dispatch": 1.7, "fuse.wait": 0.3, "stream": 1.8,
       "stream.dispatch": 1.2, "stream.wait": 0.6},
      {"fuse": 2.2, "fuse.dispatch": 1.6, "fuse.wait": 0.6, "stream": 1.5,
       "stream.dispatch": 1.2, "stream.wait": 0.3}]
# the parent commit's stage records: the stages alone
PARENT = [{"fuse_vote": 2.1, "repair": 0.04, "split": 0.01, "merge": 0.03}]
PARENT_B2 = [{"fuse": 2.0, "repair": 0.04, "stream": 1.8, "split": 0.01, "merge": 0.03}]


@pytest.mark.parametrize("name,stages,want", [
    ("scan.fusion_dispatch_ms_per_frame", MASKS, 1e3 * (1.8 + 2.1) / 2 / 300),
    ("scan.fusion_dispatch_ms_per_frame", B2, 1e3 * (1.7 + 1.6) / 2 / 300),
    ("scan.fusion_wait_ms_per_frame", MASKS, 1e3 * 0.3 / 300),
    ("scan.fusion_wait_ms_per_frame", B2, 1e3 * (0.3 + 0.6) / 2 / 300),
    ("scan.stream_wait_ms_per_frame", B2, 1e3 * (0.6 + 0.3) / 2 / 300),
])
def test_reader_means_per_frame(name, stages, want):
    assert _reader(name).read(_rec(*stages)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["scan.fusion_dispatch_ms_per_frame",
                                  "scan.fusion_wait_ms_per_frame",
                                  "scan.stream_wait_ms_per_frame"])
@pytest.mark.parametrize("stages", [PARENT, PARENT_B2, [{}], []],
                         ids=["parent_masks", "parent_b2", "no_stages", "no_requests"])
def test_reader_none_without_its_keys(name, stages):
    assert _reader(name).read(_rec(*stages)) is None


def test_stream_wait_silent_in_the_masks_cell():
    assert _reader("scan.stream_wait_ms_per_frame").read(_rec(*MASKS)) is None


def test_dispatch_and_wait_add_up_to_the_fusion_reader():
    """On records whose stages hold `dispatch + wait == stage`, the two new
    readers add up to `scan.fusion_ms_per_frame`."""
    for stages in (MASKS, B2):
        rec = _rec(*stages)
        total = _reader("scan.fusion_ms_per_frame").read(rec)
        parts = (_reader("scan.fusion_dispatch_ms_per_frame").read(rec)
                 + _reader("scan.fusion_wait_ms_per_frame").read(rec))
        assert parts == pytest.approx(total)
