"""BENCHMARK.json and the files it names: each loads, names only known
pieces and keeps to the contract's shapes; a cell added as files is found
with no edit to any file there."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "h100_bench/run.py"]
    assert b["paths"] == ["h100_bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys():
    b = bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in b[group]]
        assert len(got) == len(set(got)), group
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        assert c["file"].startswith("h100_bench/configs/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}

    def listed(m, cell):
        return "workloads" not in m or cell in m["workloads"]
    for cell in cells:
        e2e = [m["name"] for m in b["end_to_end"] if listed(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in b["per_layer"] if listed(m, cell)]
        assert layer
        for m in layer:
            moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert listed(moved, cell), (m["name"], cell)
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_each_piece_is_found_by_name():
    import harness
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        cfg = harness.load_json("configs", f"{c['name']}.json")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           f"{cfg['family']}.py"))
        assert os.path.exists(os.path.join(BENCH, "reference",
                                           f"{cfg['family']}.py"))
        assert os.path.exists(os.path.join(BENCH, "counts",
                                           f"{cfg['family']}.py"))
    for w in b["workloads"]:
        assert w["config"] in configs
        wl = harness.load_json("workloads", f"{w['name']}.json")
        assert wl["loop"] in ("eval", "train")
        mix = harness.load_json("traffic", "mixes", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{mix['generator']}.py"))
    for m in b["per_layer"]:
        reader = harness.load_module("metrics", f"{m['name']}.py")
        assert reader.read({}) is None       # nothing to read: no value


def test_limits_are_set_for_each_loop():
    import harness
    b = bench()
    for w in b["workloads"]:
        cfg = harness.load_json("configs", f"{w['config']}.json")
        loop = harness.load_json("workloads", f"{w['name']}.json")["loop"]
        limits = cfg["limits"][loop]
        assert limits and all(isinstance(v, (int, float))
                              for v in limits.values()), (w["name"], limits)


def test_a_cell_added_as_files_is_found(tmp_path):
    """A copy of the benchmark with one more cell: new files and an added
    BENCHMARK.json entry, no existing file edited; the harness finds it."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "mgar-eval-b1-copy", "config": "mgar-mil3",
                           "traffic": "jrdb-sensor-rate-copy", "chips": 1,
                           "why": "a copy"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    wl = root / "h100_bench" / "workloads"
    shutil.copy(wl / "mgar-eval-b1.json", wl / "mgar-eval-b1-copy.json")
    mixes = root / "h100_bench" / "traffic" / "mixes"
    shutil.copy(mixes / "jrdb-sensor-rate.json",
                mixes / "jrdb-sensor-rate-copy.json")
    code = ("import sys; sys.path.insert(0, 'h100_bench'); import run; "
            "s = run.cell_spec('mgar-eval-b1-copy', 1, 'cpu'); "
            "print(s['config']['family'], s['mix']['generator'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["mgar", "jrdb_clips"]


def test_run_needs_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the command exits non-zero and prints no result."""
    root = tmp_path / "only"
    shutil.copytree(BENCH, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "mgar-eval-b1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True,
                         text=True)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


@pytest.mark.parametrize("workload", ["mgar-eval-b1", "mgar-train-b1"])
def test_run_refuses_without_a_card(workload):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          workload, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
