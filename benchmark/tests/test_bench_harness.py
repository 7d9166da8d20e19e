"""The harness itself, on the CPU: the benchmark's files and their rules,
cells found by name, a cell added from files alone, the generator, the
counts, the result line and the import rules."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import BENCH, TINY, tiny_cell

from f3sbench import core, counts, room

ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names += [e["name"] for e in SPEC[group]]
    for w in SPEC["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in SPEC["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in SPEC[group]]
        assert len(ns) == len(set(ns))
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for p in BENCH.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    spec, entry, config, traffic, driver = core.load_cell(cell)
    assert config["name"] == entry["config"]
    for fn in ("setup", "warmup", "keeps", "key", "request", "release", "end_to_end",
               "reference", "compare", "check"):
        assert callable(getattr(driver, fn)), fn
    assert set(traffic["limits"][config["name"]])
    e2e = [m["name"] for m in core.cell_metrics(spec, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = core.cell_metrics(spec, cell, True)
    assert per_layer
    for m in per_layer:
        reader = core.load_module(BENCH / "metrics" / f"{m['name']}.py", "m_" + m["name"])
        assert callable(reader.read)
        assert m["moves"] in e2e


def test_every_metric_and_config_has_its_file():
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_cell_added_from_files_alone(tmp_path):
    """A new traffic file and a new entry: found and run with no code."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((bench / "traffic" / "relabel-1m-300f.json").read_text())
    traffic.update(TINY["relabel-1m-300f"], npts=30000, frames=5)
    (bench / "traffic" / "relabel-tiny.json").write_text(json.dumps(traffic))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "relabel-tiny", "config": "rtab-masks",
                              "traffic": "relabel-tiny", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "relabel-1m-300f" in m.get("workloads", []):
            m["workloads"].append("relabel-tiny")
    spec_path = tmp_path / "BENCHMARK.json"
    spec_path.write_text(json.dumps(spec))
    spec, cell, config, traffic, driver = core.load_cell("relabel-tiny", spec_path, bench)
    out = core.run_cell(spec, cell, config, traffic, driver, 3, 0.5, False, "cpu",
                        core.since_boot(), bench)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"relabel_pt_frames_per_s", "setup_s"}


def test_generator_is_deterministic_per_seed():
    K = room.pinhole(64.66, 64.56, 39.8, 31.9)
    a = room.render(room.Room(2 ** 31 + 11), 4, K, (60, 80), "cpu")
    b = room.render(room.Room(2 ** 31 + 11), 4, K, (60, 80), "cpu")
    c = room.render(room.Room(2 ** 31 + 12), 4, K, (60, 80), "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not np.array_equal(np.asarray(a[1]), np.asarray(c[1]))
    assert (np.asarray(a[0]) > 0).mean() > 0.9  # a closed room: depth almost everywhere

    def cloud(seed):
        return room.room_cloud(room.Room(5), 7000, torch.Generator().manual_seed(seed), "cpu")

    assert torch.equal(cloud(2 ** 31 + 1), cloud(2 ** 31 + 1))
    assert not torch.equal(cloud(1), cloud(2))


def test_counts_at_known_shapes():
    assert counts.k1_bytes(300, 1_000_000) == 312_000_000  # PERF.md's K1 row
    seg = json.loads((ROOT / "benchmark/configs/rtab-segformer-b2.json").read_text())["segmenter"]
    macs = counts.segformer_flops(seg, (512, 512)) / 2
    assert abs(macs / 62.4e9 - 1) < 0.01  # the paper's B2 at 512x512
    calls = counts.attention_calls(seg, (512, 512), 8)
    assert len(calls) == 16  # 3 + 4 + 6 + 3 blocks
    assert calls[0] == (0, 8, 16384, 256, 1, 64) and calls[-1] == (3, 8, 256, 256, 8, 64)
    calls = [c[1:] for c in calls]
    # [8,16384,1,64]x256 in bfloat16: bytes-bound, 0.0102 ms (PERF.md's K3 table)
    assert abs(counts.k3_bound_s(*calls[0]) * 1e3 - 0.0102) < 0.0002


def test_result_line_schema(capsys):
    spec, cell, config, traffic, driver = tiny_cell("relabel-1m-300f")
    for trace in (False, True):
        out = core.run_cell(spec, cell, config, traffic, driver, 2 ** 31 + 3, 0.3, trace, "cpu",
                            core.since_boot())
        core.emit(out)
        captured = capsys.readouterr()
        line = json.loads(captured.out.strip().splitlines()[-1])
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert ("breakdown" in line) == trace
        err = captured.err.strip().splitlines()
        assert all(e.startswith("check ") for e in err[-len(line["checks"]):])
        for name, m in line["metrics"].items():
            assert isinstance(m["value"], float) and UNIT.match(m["unit"])
        wanted = {m["name"] for m in core.cell_metrics(spec, cell["name"], trace)}
        assert set(line["metrics"]) <= wanted
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert len(line["breakdown"]["device_ops"]) <= 10


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_import_rules():
    """No file of the benchmark imports JAX or the JAX package (top-level
    names compared whole); the reference, the yardstick and the metrics
    import nothing of the program."""
    for p in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & set(core.FORBIDDEN), p
        if p.parent.name in ("reference", "f3sbench", "metrics"):
            assert "fusion3dseg_tpu_torch" not in tops, p


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fusion3dseg_tpu_torch_fake", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert core.forbidden_modules() == ["jaxlib"]


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "relabel-1m-300f",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_exits_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "relabel-1m-300f",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _k3_rec(launches):
    seg = json.loads((ROOT / "benchmark/configs/rtab-segformer-b2.json").read_text())["segmenter"]
    kernels = {"sr_attention_wgmma_kernel<bf16, 64, 128>": [launches, 1e-3]}
    return {"config": {"segmenter": seg}, "trace": {"kernels": kernels, "work": {"frames": 16}}}


def test_k3_roofline_reads_only_the_calls_it_bounds():
    """Two forwards of 8 frames: 26 fused calls (stages 0-2). A launch count
    that differs (the kernel serving stage 3 too) leaves the share unread."""
    reader = core.load_module(BENCH / "metrics" / "scan.k3_roofline.py", "k3_metric")
    share = reader.read(_k3_rec(26))
    assert share is not None and 0 < share < 100
    assert reader.read(_k3_rec(32)) is None and reader.read(_k3_rec(13)) is None
