#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

The cell is the entry of BENCHMARK.json named ``<cell>``: its workload file
(workloads/<cell>.json) names the loop and its sizes, its configuration
file (configs/<config>.json) the model family and widths, its traffic mix
(traffic/mixes/<traffic>.json) the generator and its parameters, and the
family's driver (drivers/<family>.py) builds and drives the program.

In order: load the program, make the weights and the input pool from the
seed, warm up the cell's shapes (set-up, printed by parts on standard
error), measure for ``--seconds``, then hold what the window produced to
the plain reference. The last line of standard output is the result: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics read
from a device trace with ``--trace 1``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

import harness  # noqa: E402
from harness import log  # noqa: E402

# the start of a --trace 1 window that the profiler records; the rest of
# the window, untraced, gives the rates that mfu reads
TRACE_SECONDS = 5.0


def cell_spec(workload: str, seed: int, device: str) -> dict:
    """Everything a driver needs, found by the cell's name."""
    bench = harness.benchmark_spec()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    wl = harness.load_json("workloads", f"{workload}.json")
    cfg = harness.load_json("configs", f"{entry['config']}.json")
    mix = harness.load_json("traffic", "mixes", f"{entry['traffic']}.json")
    return {"name": workload, "entry": entry, "workload": wl, "config": cfg,
            "mix": mix, "seed": int(seed), "device": device,
            # the train step's dropout stream, a function of the seed
            "dropout_seed": (int(seed) * 2654435761 + 17) % (2 ** 31)}


def end_to_end(spec: dict, rec: dict, setup_s: float,
               peak_bytes: int) -> dict:
    """The cell's end-to-end metrics, from the window's record."""
    rate = rec["requests"] * rec["batch"] / rec["elapsed_s"]
    values = {
        "setup_s": setup_s,
        "peak_mem_gib": peak_bytes / 2 ** 30,
        "latency_p95_ms": harness.quantile(rec["latencies_s"], 0.95) * 1e3,
        "train_samples_per_s": rate,
    }
    out = {}
    for m in harness.benchmark_spec()["end_to_end"]:
        if "workloads" in m and spec["name"] not in m["workloads"]:
            continue
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def run_cell(spec: dict, seconds: float, trace: bool) -> tuple:
    """Set up, measure and check one cell: (result line, checks), or
    (None, message) where no result may be printed."""
    driver = harness.load_module("drivers",
                                 f"{spec['config']['family']}.py")
    chips = spec["entry"]["chips"]
    clock = harness.SetupClock(T0)
    cell = driver.Cell(spec)
    cell.setup(clock)
    # what set-up made lives through the window: keep the collector's full
    # passes from walking it inside the window
    gc.collect()
    gc.freeze()
    setup_s = clock.total()
    log("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                              clock.parts.items())
        + f"; nvcc build {cell.records.get('build_seconds', 0.0):.3f} s"
        + f"; total {setup_s:.3f} s")
    trace_s = min(seconds, TRACE_SECONDS)
    rec = cell.window(seconds, trace, trace_s)
    log(f"window: {rec['requests']} "
        f"{'requests' if rec['loop'] == 'eval' else 'micro-steps'} in "
        f"{rec['elapsed_s']:.3f} s")
    dev = harness.device_info(spec["device"], chips)
    if trace:
        records = dict(rec, peaks=harness.load_json("peaks.json"),
                       cell=spec["name"], platform=dev["platform"])
        metrics = harness.per_layer_metrics(spec["name"], records)
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["window_s"]
        ops = sorted(rec["kernels"].items(), key=lambda kv: -kv[1]["s"])
        breakdown = {"device_ops": [[n, v["s"]] for n, v in ops[:10]],
                     "idle_gaps": rec["idle_gaps"][:10]}
    else:
        metrics = end_to_end(spec, rec, setup_s, dev["memory_peak_bytes"])
        breakdown = None
    cell.release()
    t_ref = time.perf_counter()
    checks = cell.checks()
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    found = harness.forbidden_loaded()
    if found:
        return None, f"forbidden modules loaded in this process: {found}"
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": rec["requests"], "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    lag = rec.get("start_lag_s")
    if lag:
        # how late the open loop started its requests against their due
        # times: a generator that falls behind offers less than the mix
        result["generator"] = {"start_lag_mean_ms": 1e3 * sum(lag) / len(lag),
                               "start_lag_max_ms": 1e3 * max(lag)}
        log("generator: start lag mean "
            f"{result['generator']['start_lag_mean_ms']:.3f} ms, max "
            f"{result['generator']['start_lag_max_ms']:.3f} ms")
    return result, checks


def run(args) -> int:
    spec = cell_spec(args.workload, args.seed, "cuda")
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result, checks = run_cell(spec, args.seconds, bool(args.trace))
    if result is None:
        log(checks)
        return 4
    harness.emit(result, checks)
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.exit(run(parse()))
