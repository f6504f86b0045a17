#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 h100_bench/calibrate.py --workload <cell> --seeds <n> ...
        [--control-seeds <k>] [--seconds <s>]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` served back to back (an eval cell; a training cell's readings
come from its set-up), then the numbers that decide ``correct`` of the
program against the plain reference; for the first ``--control-seeds``
seeds also the control's: the reference computed with TF32, the precision
below the configuration's float32, in the program's place. ``--fault``
plants one of faults.py's faults in the program. One JSON line a seed on
standard output. The limits in configs/<config>.json were set
from these readings (PERF.md gives them).
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (HERE, os.path.dirname(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

import harness  # noqa: E402
import run  # noqa: E402


def readings(workload: str, seed: int, control: bool, seconds: float,
             device: str = "cuda", fault: str = None) -> dict:
    """One seed's numbers: the program's (with ``fault`` planted, a name of
    faults.FAULTS) and, with ``control``, the control's."""
    if fault:
        import faults
        with faults.FAULTS[fault]():
            return readings(workload, seed, False, seconds, device)
    spec = run.cell_spec(workload, seed, device)
    spec["mix"]["params"]["rate_per_s"] = None       # back to back
    driver = harness.load_module("drivers",
                                 f"{spec['config']['family']}.py")
    ref = harness.load_module("reference", f"{spec['config']['family']}.py")
    compare = harness.load_module("reference", "compare.py")
    cell = driver.Cell(spec)
    cell.setup(harness.SetupClock(time.perf_counter()))
    cell.window(seconds, False, seconds)
    cell.release()
    out = {"seed": seed}
    if cell.loop == "eval":
        got = {i: compare.flat_outputs(o) for i, o in cell.outputs.items()}
        clips = {i: cell.pool[i] for i in sorted(cell.outputs)}
        want = ref.eval_outputs(spec["config"], seed, clips, device)
        out["program"] = compare.eval_numbers(got, want)
        if control:
            low = ref.eval_outputs(spec["config"], seed, clips, device,
                                   tf32=True)
            out["control"] = compare.eval_numbers(low, want)
    else:
        args = (spec["config"], spec["workload"], seed, spec["dropout_seed"],
                cell.pool, device)
        want = ref.train_readings(*args)
        nums = compare.train_numbers(cell.records["train_readings"], want)
        out["program"] = nums
        if control:
            low = ref.train_readings(*args, tf32=True)
            out["control"] = compare.train_numbers(low, want)
    for side in ("program", "control"):
        if side in out and "left_out_leaves" in out[side]:
            out[side]["left_out_leaves"] = len(out[side]["left_out_leaves"])
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None,
                   help="plant a fault of faults.py in the program")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    for i, seed in enumerate(args.seeds):
        line = readings(args.workload, seed, i < args.control_seeds,
                        args.seconds, fault=args.fault)
        line["fault"] = args.fault
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
