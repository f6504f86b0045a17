"""The port's VoxelResBackbone8x, VoxelNeXt and PV-RCNN++ against the JAX
package's at tiny configs (those of tests/test_detection_sparse.py and
tests/test_detection_next.py), with the helpers of
tests/test_torch_det_common.py: one float64 JAX run per model, every leaf
to 1e-4 of its largest reference value, ``predict``'s valid sets and
labels exactly; the training comparison of PV-RCNN++ feeds the JAX
sampler's RoIs to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models.sparse_backbone import SparseTensor as JaxST
from multimodal_gar_tpu_torch.convert import load_jax_variables
from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
from multimodal_gar_tpu_torch.utils.testing import sparse_input_numpy
from tests.test_detection import det_batch, tiny_voxel_cfg
from tests.test_torch_common import assert_close, random_variables, to_jax
from tests.test_torch_det_common import (check_eval, check_train,
                                         check_train_with_jax_sampler,
                                         expected_tensors, family_setup,
                                         port_batch, port_cfg, with_points)

TOL = 1e-4
CPU = dict(device="cpu")


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.fixture(scope="module")
def res_backbone():
    """VoxelResBackbone8x: eval outputs, and the training forward's
    outputs, gradients and statistics under a fixed linear loss, in one
    float64 JAX jit. Caps below the tiny scene's sites drop some."""
    from multimodal_gar_tpu.detection.sparse_backbones import (
        VoxelResBackbone8x)
    caps = (40, 16, 8, 4)
    f, c, v, shape = sparse_input_numpy(m=40, c=4, shape=(9, 16, 16))
    jst = JaxST(jnp.asarray(f), jnp.asarray(c), jnp.asarray(v), shape)
    jmodel = VoxelResBackbone8x(max_voxels_per_stage=caps)
    variables = random_variables(jmodel, jst, train=False, seed=1)
    rng = np.random.default_rng(9)
    proj = {k: rng.normal(size=(2, m, ch))
            for k, m, ch in (("x_conv1", 40, 16), ("x_conv2", 16, 32),
                             ("x_conv3", 8, 64), ("x_conv4", 4, 128))}

    def run(variables, st):
        ev = jmodel.apply(variables, st, train=False)

        def loss_fn(params):
            ms, upd = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                st, train=True, mutable=["batch_stats"])
            loss = sum(jnp.sum(ms[k].features * proj[k]) for k in proj)
            return loss, (ms, upd["batch_stats"])
        (_, (tr, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return ev, tr, grads, stats

    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), to_jax(variables))
        st64 = jst.replace(features=jnp.asarray(f, jnp.float64))
        ref = jax.device_get(jax.jit(run)(wide, st64))
    from multimodal_gar_tpu_torch.detection.sparse_backbones import (
        VoxelResBackbone8x as Port)
    return dict(variables=variables, ref=ref, proj=proj,
                st=SparseTensor(torch.from_numpy(f), torch.from_numpy(c),
                                torch.from_numpy(v), shape),
                model_fn=lambda: Port(4, max_voxels_per_stage=caps,
                                      generator=_gen(), **CPU))


def _compare_ms(got, ref, what):
    for k, st in ref.items():
        np.testing.assert_array_equal(got[k].valid.numpy(),
                                      np.asarray(st.valid), f"{what} {k}")
        v = np.asarray(st.valid)
        np.testing.assert_array_equal(got[k].coords.numpy()[v],
                                      np.asarray(st.coords)[v])
        assert_close(got[k].features.detach().numpy(),
                     np.asarray(st.features), TOL, f"{what} {k}")


def test_voxel_res_backbone_matches_jax(res_backbone):
    s = res_backbone
    ev, tr, grads, stats = s["ref"]
    model = load_jax_variables(s["model_fn"](), s["variables"]).eval()
    with torch.no_grad():
        _compare_ms(model(s["st"]), ev, "eval")
    # the caps cut sites off: the maps were built on the device
    assert int(sum(t.sum() for t in model.dropped_sites.values())) > 0
    model.train()
    ms = model(s["st"])
    _compare_ms(ms, tr, "train")
    loss = sum((ms[k].features * torch.from_numpy(p).float()).sum()
               for k, p in s["proj"].items())
    loss.backward()
    want = expected_tensors(model, grads, stats)
    for name, p in model.named_parameters():
        assert_close(p.grad.numpy(), want[name].numpy(), TOL,
                     f"grad {name}")
    for name, b in model.named_buffers():
        assert_close(b.numpy(), want[name].numpy(), TOL, f"new {name}")


def _vn_cfg(m):
    return m.VoxelNeXtConfig(channels=(8, 8, 16, 16, 16), out_channel=16,
                             max_bev_voxels=64, max_boxes=16)


@pytest.fixture(scope="module")
def voxelnext():
    import multimodal_gar_tpu.detection.voxelnext as jax_vn
    import multimodal_gar_tpu_torch.detection.voxelnext as port_vn
    jcfg = tiny_voxel_cfg("SECOND")
    jb = det_batch(jcfg, batch_size=2, seed=3, m=96)
    cfg = port_cfg(jcfg)
    return family_setup(
        jax_vn.VoxelNeXtDetector(jcfg, _vn_cfg(jax_vn)), jb,
        lambda: port_vn.VoxelNeXtDetector(cfg, _vn_cfg(port_vn),
                                          generator=_gen(), **CPU))


def test_voxelnext_eval_and_predict_match_jax(voxelnext):
    preds = check_eval(voxelnext, "VoxelNeXt")
    assert preds["bev_valid"].any()


def test_voxelnext_train_step_matches_jax(voxelnext):
    check_train(voxelnext["model_fn"], voxelnext["variables"],
                port_batch(voxelnext["jb"]), voxelnext["ref"], "VoxelNeXt")


def test_voxelnext_reports_the_dilated_sets_dropped_sites(voxelnext):
    model = load_jax_variables(voxelnext["model_fn"](),
                               voxelnext["variables"]).eval()
    with torch.no_grad():
        model(port_batch(voxelnext["jb"]))
    dropped = model.backbone_3d.conv_out.conv.dropped_sites
    assert dropped.shape == (2,) and int(dropped.sum()) == 0
    assert set(model.backbone_3d.dropped_sites) == {1, 2, 3, 4, 5}


def _pp_cfgs(roi_m, pp_m):
    roi = roi_m.RoIHeadConfig(
        shared_fc=(32,), cls_fc=(16,), reg_fc=(16,), grid_size=3,
        dp_ratio=0.0, pool_radii=(1.6,),
        sampler=roi_m.RoISamplerConfig(roi_per_image=8),
        train_nms=roi_m.NMSConfig(nms_thresh=0.8, nms_pre_maxsize=32,
                                  nms_post_maxsize=16, score_thresh=0.0),
        test_nms=roi_m.NMSConfig(nms_thresh=0.7, nms_pre_maxsize=32,
                                 nms_post_maxsize=8, score_thresh=0.0))
    pp = pp_m.PVPPConfig(num_keypoints=36, num_sectors=6, vp_mlp=8,
                         num_output_features=16, vp_radii=(0.8, 1.6),
                         vsa_sources=(("x_conv3", 4, 1.2),
                                      ("x_conv4", 8, 2.4)))
    return roi, pp


@pytest.fixture(scope="module")
def pvrcnn_pp():
    import types
    import multimodal_gar_tpu.detection.post as jpost
    import multimodal_gar_tpu.detection.pv_rcnn_pp as jax_pp
    import multimodal_gar_tpu.detection.roi_detectors as jroi
    import multimodal_gar_tpu.detection.roi_heads as jheads
    import multimodal_gar_tpu_torch.detection.post as ppost
    import multimodal_gar_tpu_torch.detection.pv_rcnn_pp as port_pp
    import multimodal_gar_tpu_torch.detection.roi_detectors as proi
    import multimodal_gar_tpu_torch.detection.roi_heads as pheads
    jcfg = tiny_voxel_cfg("SECOND")
    jroi_cfg, jpp = _pp_cfgs(types.SimpleNamespace(
        RoIHeadConfig=jroi.RoIHeadConfig,
        RoISamplerConfig=jheads.RoISamplerConfig,
        NMSConfig=jpost.NMSConfig), jax_pp)
    proi_cfg, ppp = _pp_cfgs(types.SimpleNamespace(
        RoIHeadConfig=proi.RoIHeadConfig,
        RoISamplerConfig=pheads.RoISamplerConfig,
        NMSConfig=ppost.NMSConfig), port_pp)
    jb = with_points(det_batch(jcfg, batch_size=2, seed=3, m=96), jcfg, 150,
                     seed=7, invalid=30)
    cfg = port_cfg(jcfg)
    return family_setup(
        jax_pp.PVRCNNPlusPlusDetector(jcfg, jroi_cfg, jpp), jb,
        lambda: port_pp.PVRCNNPlusPlusDetector(cfg, proi_cfg, ppp,
                                               generator=_gen(), **CPU))


def test_pvrcnn_pp_eval_and_predict_match_jax(pvrcnn_pp):
    preds = check_eval(pvrcnn_pp, "PV-RCNN++")
    # the sector FPS picks the JAX FPS's points, exactly
    np.testing.assert_array_equal(
        preds["keypoints"].numpy(),
        np.asarray(pvrcnn_pp["ref"]["eval_preds"]["keypoints"], np.float32))


def test_pvrcnn_pp_train_step_matches_jax(pvrcnn_pp, monkeypatch):
    from multimodal_gar_tpu_torch.utils.testing import PVPP_CANCELLED_BIASES
    check_train_with_jax_sampler(pvrcnn_pp, "PV-RCNN++", monkeypatch,
                                 PVPP_CANCELLED_BIASES)


@pytest.mark.parametrize("name", ["PVRCNN", "SECONDNetIoU", "PartA2",
                                  "PointRCNN", "VoxelNeXt", "PV-RCNN++"])
def test_export_then_convert_round_trips(name):
    """export_variables (the flax layout: dense 3D and (27, Cin, Cout)
    sparse kernels, the SA MLPs, the point heads, the BatchNorms) then
    convert_variables gives every tensor back exactly."""
    from multimodal_gar_tpu_torch.convert import (convert_variables,
                                                  export_variables)
    from multimodal_gar_tpu_torch.utils.testing import (
        tiny_second_slice_detector)
    model = tiny_second_slice_detector(name, generator=_gen(), **CPU)
    other = tiny_second_slice_detector(
        name, generator=torch.Generator().manual_seed(1), **CPU)
    back = convert_variables(export_variables(model), other)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
