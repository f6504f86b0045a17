"""The readers of the program's spans (metrics/*.py over
utils/profiling.py: span_records): nothing to read on ``{}``, in the
other loop or in a program without spans; in a traced CPU run of each cell
at tiny size, the mean host time of their span, reported in that cell
alone beside every metric the cell had."""
import sys
import types

import pytest

import harness
import run
from conftest import tiny_spec

SPANS = {"losses_ms.train": ("train", "train_step.losses"),
         "backward_ms.train": ("train", "train_step.backward"),
         "guard_ms.train": ("train", "train_step.guard"),
         "update_ms.train": ("train", "train_step.update"),
         "sparse_backbone_ms.eval": ("eval", "lidar.sparse_backbone"),
         "grid_pool_ms.eval": ("eval", "lidar.grid_pool"),
         "dafm_ms.eval": ("eval", "fusion.dafm")}
CELLS = {"eval": "mgar-eval-b1", "train": "mgar-train-b1"}


def _reader(name):
    return harness.load_module("metrics", f"{name}.py")


@pytest.mark.parametrize("name", sorted(SPANS))
def test_nothing_to_read_outside_the_loop_or_without_spans(name,
                                                            monkeypatch):
    loop = SPANS[name][0]
    other = "eval" if loop == "train" else "train"
    reader = _reader(name)
    assert reader.read({}) is None
    assert reader.read({"loop": other}) is None
    monkeypatch.setitem(sys.modules,
                        "multimodal_gar_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert reader.read({"loop": loop}) is None


def _traced_run(loop):
    from multimodal_gar_tpu_torch.utils.profiling import (reset_spans,
                                                          span_records)
    spec = tiny_spec(CELLS[loop], 7, pool=2)
    if loop == "train":
        spec["workload"]["checked_updates"] = 1
        spec["config"]["overrides"]["train"]["grad_accum_steps"] = 2
    reset_spans()
    result, checks = run.run_cell(spec, 0.5, True)
    assert result is not None, checks
    return result, span_records().records


@pytest.fixture(scope="module")
def traced():
    return {loop: _traced_run(loop) for loop in CELLS}


@pytest.mark.parametrize("loop", sorted(CELLS))
def test_a_traced_run_reports_the_mean_of_each_span(loop, traced):
    result, records = traced[loop]
    metrics = result["metrics"]
    for name, (want_loop, span) in SPANS.items():
        if want_loop != loop:
            assert name not in metrics
            continue
        xs = [r["host_ms"] for r in records if r["name"] == span]
        assert xs and all(r["device_ms"] is None for r in records)
        assert metrics[name]["value"] == pytest.approx(sum(xs) / len(xs),
                                                       rel=1e-12)
        assert metrics[name]["unit"] == "ms"
    # the benchmark's own per-layer metrics of the cell are all still there
    had = {m["name"] for m in harness.benchmark_spec()["per_layer"]
           if CELLS[loop] in m.get("workloads", [CELLS[loop]])
           and m["name"] not in SPANS and m["source"] != "device_trace"
           and "mfu" not in m["name"]}
    assert had <= set(metrics), had - set(metrics)
