"""The plain reference against the port at tiny sizes on the CPU: a sound
run of each cell comes out correct; a run whose timed path is broken
underneath comes out not correct, once for each fault the cell can have
(an answer altered where it is produced; a step that leaves its state
unchanged; no cell has a batch to halve, as both take one clip at a
time). On the card, the control (the reference at TF32 in the program's
place) fails a cell's numbers."""
import pytest

import run
from conftest import tiny_spec


def _train_spec(seed):
    spec = tiny_spec("mgar-train-b1", seed)
    spec["workload"]["checked_updates"] = 1
    spec["config"]["overrides"]["train"]["grad_accum_steps"] = 2
    return spec


SPECS = {"mgar-eval-b1": lambda s: tiny_spec("mgar-eval-b1", s),
         "mgar-train-b1": _train_spec}


def _run(name, seed=11):
    result, checks = run.run_cell(SPECS[name](seed), 0.5, False)
    assert result is not None, checks
    return result, checks


@pytest.mark.parametrize("name", sorted(SPECS))
def test_a_sound_run_is_correct(name):
    result, checks = _run(name)
    assert result["correct"], checks
    assert all(c["limit"] is not None for c in checks)


@pytest.mark.parametrize("fault, name", [
    ("answer_altered", "mgar-eval-b1"),
    ("state_unchanged_mgar", "mgar-train-b1")])
def test_a_fault_is_caught(fault, name):
    import faults
    with faults.FAULTS[fault]():
        result, checks = _run(name)
    assert not result["correct"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPECS))
def test_the_control_fails_on_the_card(name, cuda_device):
    """The reference at TF32 in the program's place, at the cell's own
    sizes: at least one number over its limit."""
    import calibrate
    spec = run.cell_spec(name, 5, cuda_device)
    line = calibrate.readings(name, 2 ** 31 + 5, True, 1.0, cuda_device)
    limits = spec["config"]["limits"][spec["workload"]["loop"]]
    assert any(line["control"][k] > v for k, v in limits.items()), line
