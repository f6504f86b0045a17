"""VoxelNeXt at ``DetectorConfig.dtype: bfloat16`` against the JAX
package's at bf16 (the eval forward, ``predict`` and one b2 train step),
and PV-RCNN, SECONDNetIoU and PV-RCNN++ at bf16 (eval and ``predict``),
at the tiny configs of tests/test_torch_det_next.py and
tests/test_torch_det_two_stage.py, by the rules and helpers of
tests/test_torch_bf16_det_zoo_parta2.py: JAX's own drift on nudged voxels
decides where bounds 1 and 2 hold, bound 2's float32 side the port's own
float32 model.
"""
import pytest

from tests.test_torch_bf16_det_zoo_parta2 import (
    _runs, check_eval_bf16, check_train_bf16, check_two_stage_eval_bf16)


def test_voxelnext_eval_and_predict_match_jax_bf16():
    """The residual stages to stride 32, conv_out and shared_conv at bf16
    (K3 and the (1, 3, 3) gather + matmul), the BEV collapse and the heads
    float32."""
    check_eval_bf16(_runs("VoxelNeXt"), "VoxelNeXt")


def test_voxelnext_train_step_matches_jax_bf16():
    check_train_bf16(_runs("VoxelNeXt"), "VoxelNeXt")


@pytest.mark.parametrize("name", ["PVRCNN", "PV-RCNN++"])
def test_two_stage_eval_and_predict_match_jax_bf16(name):
    """Their trunk (VoxelBackbone8x, conv_out) at bf16, as the JAX
    package's; the point and RoI stages float32 there and here. PV-RCNN at
    batch 1 (tests/test_torch_det_two_stage.py says why)."""
    check_two_stage_eval_bf16(name)
