"""utils/parallel_testing.py ``mgar_steps(float64=True)``, the float64
reference that ``tools/parallel_check.py --float64`` runs at world 4: one
tiny MGAR micro-step on the CPU in float64 (the plain kernel versions take
float64 CPU tensors) against the same step in float32, the losses to 1e-5
and Adam's first moments to 1e-3 of each leaf's largest value (float32
rounding through a whole step, the gradients' noise leaves held under
1e-3 of the median leaf as tools/parallel_check.py holds them), the
parameters float64, and the default dtype restored after the run.
"""
import torch

from multimodal_gar_tpu_torch.utils.parallel_testing import (check_leaves,
                                                             leaf_errors,
                                                             mgar_steps)
from multimodal_gar_tpu_torch.utils.testing import tiny_config


def test_float64_step_matches_float32_and_restores_the_default():
    kw = dict(cfg=tiny_config(), synthetic=dict(batch_size=1, seed=0),
              dropout=False, first_moments=True)
    ref = mgar_steps(None, "cpu", **kw)
    wide = mgar_steps(None, "cpu", float64=True, **kw)
    assert torch.get_default_dtype() == torch.float32
    assert all(v.dtype == torch.float64 for v in wide["model"].values()
               if v.is_floating_point())
    a, b = wide["metrics"][0]["loss"], ref["metrics"][0]["loss"]
    assert abs(a - b) <= 1e-5 * abs(a), (a, b)
    names = ref["names"]
    got = dict(zip(names, wide["first_exp_avg"]))
    want = dict(zip(names, ref["first_exp_avg"]))
    check_leaves(leaf_errors({k: v.float() for k, v in got.items()}, want),
                 1e-3, "float64 against float32 first moments", noise=True)
