"""The reader of the engine's graph counter (`scan.fusion_graph_share`) on
synthetic records: the mean share over the window's sessions, and None
where the program records no such key (as a program without it does)."""

import pytest
from conftest import BENCH

from f3sbench import core


def _reader():
    return core.load_module(BENCH / "metrics" / "scan.fusion_graph_share.py",
                            "graph_scan_fusion_graph_share")


def _rec(*stages, frames=300):
    return {"requests": [{"frames": frames, "stages": s} for s in stages]}


GRAPHED = [{"fuse_vote": 1.5, "fuse_graph.frames": 299.0, "fuse_graph.captures": 0.0},
           {"fuse_vote": 1.6, "fuse_graph.frames": 299.0, "fuse_graph.captures": 1.0}]
EAGER = [{"fuse": 2.0, "fuse_graph.frames": 0.0, "fuse_graph.captures": 0.0}]


@pytest.mark.parametrize("stages,want", [
    (GRAPHED, 100.0 * 299 / 300),
    (GRAPHED[:1] + EAGER, 100.0 * 299 / 300 / 2),
    (EAGER, 0.0),
], ids=["graphed", "half", "eager"])
def test_share_of_two_requests(stages, want):
    assert _reader().read(_rec(*stages)) == pytest.approx(want)


@pytest.mark.parametrize("stages", [[{"fuse_vote": 2.1, "repair": 0.04}], [{}], []],
                         ids=["parent", "no_stages", "no_requests"])
def test_none_without_the_key(stages):
    assert _reader().read(_rec(*stages)) is None


def test_requests_without_stages():
    """The relabel driver's requests carry empty stages: nothing to read."""
    assert _reader().read({"requests": [{"frames": 300, "stages": {}},
                                        {"frames": 300}]}) is None
