"""The port's CaDDN (detection/caddn.py) and its DeepLabV3 depth network
(detection/ddn_deeplab.py) against the JAX package's: depth binning (the
targets exactly), the frustum-to-voxel sampling and DeepLab's logit resize
to 1e-5, the compact CaDDN's eval forward, ``predict``, losses (the depth
loss also with the fg / bg balancer), gradients, new statistics and one
train step to 1e-4 against one float64 JAX run (tests/test_torch_det_
common.py), and DeepLabV3-ResNet50 at an odd image size on a
torchvision-format state dict loaded by both packages' loaders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.detection import caddn as jax_caddn
from multimodal_gar_tpu_torch.detection import caddn
from tests.test_detection import det_batch, tiny_voxel_cfg
from tests.test_torch_common import assert_close, random_variables, to_jax
from tests.test_torch_det_common import (check_train, compare_predict,
                                         compare_tree, jax_run, port_batch,
                                         port_cfg)

TOL = 1e-4
SAMPLE_TOL = 1e-5


@pytest.mark.parametrize("mode", ["UD", "LID", "SID"])
def test_bin_depths_matches_jax(mode):
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(0.5, 50.0, 500),
                        [2.0, 46.8, 100.0, np.inf, -np.inf, np.nan, 0.0]])
    d = d.astype(np.float32)
    for target in (False, True):
        ref = np.asarray(jax_caddn.bin_depths(jnp.asarray(d), mode, 2.0,
                                              46.8, 80, target=target))
        got = caddn.bin_depths(torch.from_numpy(d), mode, 2.0, 46.8, 80,
                               target=target).numpy()
        if target:
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, ref)
            assert got[-4] == 80                # inf: the sky bin
        else:
            fin = np.isfinite(ref)
            np.testing.assert_array_equal(np.isfinite(got), fin)
            assert_close(got[fin], ref[fin], SAMPLE_TOL, mode)


# the JAX test's calibration: camera x = -lidar y, y = -lidar z, z = lidar
# x, a pinhole with f = 30 and its centre at (32, 16) of a 32 x 64 image
L2C = np.asarray([[0., -1., 0., 0.], [0., 0., -1., 0.], [1., 0., 0., 0.],
                  [0., 0., 0., 1.]], np.float32)
K = np.asarray([[30., 0., 32., 0.], [0., 30., 16., 0.], [0., 0., 1., 0.]],
               np.float32)
CD = dict(ddn_arch="compact", num_depth_bins=8, depth_min=1.0,
          depth_max=17.0, ddn_channels=(8, 16), channel_reduce=8,
          bev_collapse_channels=16, downsample_factor=4)


def test_frustum_to_voxel_matches_jax():
    """A random frustum sampled into the tiny CaDDN grid: voxels inside,
    on the frustum's last column (one corner clipped onto the edge) and
    outside (zero)."""
    cfg = jax_caddn.CaDDNConfig(**CD)
    grid, pc = (64, 64, 4), (0.0, -8.0, -1.5, 16.0, 8.0, 1.5)
    rng = np.random.default_rng(1)
    fr = rng.normal(size=(8, 16, 8, 5)).astype(np.float32)
    ref = np.asarray(jax_caddn.frustum_to_voxel(
        jnp.asarray(fr), jnp.asarray(L2C), jnp.asarray(K), (32, 64), grid,
        pc, cfg))
    got = caddn.frustum_to_voxel(
        torch.from_numpy(fr), torch.from_numpy(L2C), torch.from_numpy(K),
        (32, 64), grid, pc, caddn.CaDDNConfig(**CD)).numpy()
    assert_close(got, ref, SAMPLE_TOL, "frustum_to_voxel")
    # the feature-map column of each voxel centre
    x = (np.arange(64) + 0.5) * 0.25
    y = -8.0 + (np.arange(64) + 0.5) * 0.25
    uf = (30.0 * -y[:, None] / x[None, :] + 32.0) / 4.0      # (ny, nx)
    border = (uf >= 15.0) & (uf < 16.0)
    outside = (uf < 0) | (uf >= 16.0)
    assert border.any() and outside.any()
    mag = np.abs(ref).sum((0, 3))                            # (ny, nx)
    assert (mag[outside] == 0).all() and (mag[border] > 0).any()


def test_deeplab_logit_resize_matches_jax():
    """DeepLab's upsample of the logits to the layer1 map at a ratio that
    is no integer: jax.image.resize "linear" = bilinear, align_corners
    False."""
    import torch.nn.functional as F
    x = np.random.default_rng(2).normal(size=(2, 5, 9, 7)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 9, 17, 7),
                                      method="linear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(9, 17),
                        mode="bilinear", align_corners=False)
    assert_close(got.permute(0, 2, 3, 1).numpy(), ref, SAMPLE_TOL, "resize")


def _tiny_cfg():
    base = tiny_voxel_cfg("SECOND")
    return dataclasses.replace(
        base, name="CaDDN", voxel_size=(0.25, 0.25, 0.75),   # 64 x 64 x 4
        anchors=tuple(dataclasses.replace(a, feature_map_stride=2)
                      for a in base.anchors),
        bev_layer_nums=(1, 1), bev_layer_strides=(2, 2),
        bev_num_filters=(16, 32), bev_upsample_strides=(1, 2),
        bev_num_upsample_filters=(16, 16))


@pytest.fixture(scope="module")
def tiny_caddn():
    """The JAX test's compact CaDDN at batch 2, numpy-drawn weights, one
    float64 JAX run (jax_run): eval, predict, training losses, gradients,
    statistics, one AdamW step."""
    jcfg = _tiny_cfg()
    jmodel = jax_caddn.CaDDNDetector(jcfg, jax_caddn.CaDDNConfig(**CD))
    jb = det_batch(jcfg, batch_size=2, m=16, seed=5)
    rng = np.random.default_rng(2)
    h, w = 32, 64
    k = np.stack([K, K * np.asarray([[1.05], [1.05], [1.0]], np.float32)])
    jb = jb.replace(
        images=jnp.asarray(rng.uniform(0, 1, (2, h, w, 3)), jnp.float32),
        lidar_to_cam=jnp.asarray(np.stack([L2C, L2C])),
        cam_to_img=jnp.asarray(k),
        depth_maps=jnp.asarray(rng.uniform(1, 17, (2, h, w)), jnp.float32))
    variables = random_variables(jmodel, jb, train=False, seed=1)
    ref = jax_run(jmodel, to_jax(variables), jb)
    cfg = port_cfg(jcfg)

    def model_fn():
        return caddn.CaDDNDetector(cfg, caddn.CaDDNConfig(**CD),
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    return dict(jmodel=jmodel, jb=jb, variables=variables, ref=ref,
                model_fn=model_fn)


def test_caddn_eval_and_predict_match_jax(tiny_caddn):
    from multimodal_gar_tpu_torch.convert import load_jax_variables
    s = tiny_caddn
    model = load_jax_variables(s["model_fn"](), s["variables"]).eval()
    with torch.no_grad():
        preds = model(port_batch(s["jb"]))
        out = model.predict(preds)
    compare_tree(preds, s["ref"]["eval_preds"], "CaDDN eval")
    compare_predict(out, s["ref"]["predict"], "CaDDN predict")


def test_caddn_trains_as_jax(tiny_caddn):
    s = tiny_caddn
    check_train(s["model_fn"], s["variables"], port_batch(s["jb"]),
                s["ref"], "CaDDN")


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


def test_caddn_at_a_bf16_config_computes_float32_as_jax(tiny_caddn):
    """DetectorConfig.dtype bfloat16: the JAX CaDDNDetector never reads the
    dtype and computes in float32. The port's CaDDN builds at that config,
    and its eval outputs equal its float32 run bit for bit; the JAX CaDDN
    at bfloat16 (float32, jitted) and at float32 (the fixture's float64
    run) agree with both to TOL."""
    from multimodal_gar_tpu_torch.convert import load_jax_variables
    s = tiny_caddn
    jcfg = s["jmodel"].cfg
    batch = port_batch(s["jb"])
    outs = {}
    for dtype in ("float32", "bfloat16"):
        model = caddn.CaDDNDetector(
            port_cfg(dataclasses.replace(jcfg, dtype=dtype)),
            caddn.CaDDNConfig(**CD), device="cpu",
            generator=torch.Generator().manual_seed(0))
        model = load_jax_variables(model, s["variables"]).eval()
        with torch.no_grad():
            outs[dtype] = model(batch)
    assert _equal_trees(outs["float32"], outs["bfloat16"])
    jmodel = jax_caddn.CaDDNDetector(
        dataclasses.replace(jcfg, dtype="bfloat16"),
        jax_caddn.CaDDNConfig(**CD))
    jax_bf16 = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        to_jax(s["variables"]), s["jb"])
    for dtype, out in outs.items():
        compare_tree(out, jax_bf16, f"CaDDN {dtype} vs JAX at bfloat16")
        compare_tree(out, s["ref"]["eval_preds"],
                     f"CaDDN {dtype} vs JAX at float32")


def test_ddn_loss_with_the_balancer_matches_jax(tiny_caddn):
    """ddn_loss with a foreground mask (the fg / bg balancer) and without,
    on the JAX run's eval depth logits."""
    s = tiny_caddn
    logits = np.asarray(s["ref"]["eval_preds"]["depth_logits"], np.float32)
    dm = np.array(s["jb"].depth_maps)
    fg = np.random.default_rng(3).uniform(size=logits.shape[:3]) < 0.2
    model = s["model_fn"]()
    for mask in (None, fg):
        ref = s["jmodel"].ddn_loss(
            jnp.asarray(logits), jnp.asarray(dm),
            None if mask is None else jnp.asarray(mask))
        got = model.ddn_loss(torch.from_numpy(logits), torch.from_numpy(dm),
                             None if mask is None else torch.from_numpy(mask))
        assert_close(got.numpy(), np.asarray(ref), TOL,
                     f"ddn_loss, mask {mask is not None}")


def _torchvision_state_dict(seed: int = 0, classes: int = 9) -> dict:
    """A torchvision deeplabv3_resnet50 state dict of numpy arrays drawn
    from ``seed`` (BN statistics and scales near their trained ranges)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(prefix, cout, cin, k):
        sd[f"{prefix}.weight"] = (rng.normal(size=(cout, cin, k, k))
                                  * (cin * k * k) ** -0.5).astype(np.float32)

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c).astype(
            np.float32)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    for li, (blocks, planes, cin) in {1: (3, 64, 64), 2: (4, 128, 256),
                                      3: (6, 256, 512),
                                      4: (3, 512, 1024)}.items():
        for bi in range(blocks):
            p = f"backbone.layer{li}.{bi}"
            conv(f"{p}.conv1", planes, cin, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if bi == 0:
                conv(f"{p}.downsample.0", planes * 4, cin, 1)
                bn(f"{p}.downsample.1", planes * 4)
            cin = planes * 4
    conv("classifier.0.convs.0.0", 256, 2048, 1)
    bn("classifier.0.convs.0.1", 256)
    for i in (1, 2, 3):
        conv(f"classifier.0.convs.{i}.0", 256, 2048, 3)
        bn(f"classifier.0.convs.{i}.1", 256)
    conv("classifier.0.convs.4.1", 256, 2048, 1)
    bn("classifier.0.convs.4.2", 256)
    conv("classifier.0.project.0", 256, 1280, 1)
    bn("classifier.0.project.1", 256)
    conv("classifier.1", 256, 256, 3)
    bn("classifier.2", 256)
    conv("classifier.4", classes, 256, 1)
    sd["classifier.4.bias"] = rng.normal(0, 0.1, classes).astype(np.float32)
    return sd


def test_deeplabv3_resnet50_matches_jax_on_a_torchvision_state_dict():
    """DeepLabV3DDN (ResNet50) at a 33 x 65 image: both packages load the
    same torchvision-format state dict with their own loaders; features
    and logits agree, and the JAX variables carried over by convert.py
    give the port the same tensors as its loader."""
    from multimodal_gar_tpu.detection.ddn_deeplab import (
        DeepLabV3DDN as JaxDDN, load_torchvision_deeplab as jax_load)
    from multimodal_gar_tpu_torch.convert import convert_variables
    from multimodal_gar_tpu_torch.detection.ddn_deeplab import (
        DeepLabV3DDN, load_torchvision_deeplab)
    sd = _torchvision_state_dict()
    x = np.random.default_rng(4).uniform(0, 1, (1, 33, 65, 3)).astype(
        np.float32)
    x[0, :3, :5] = 0.0                          # padded pixels stay zero
    jm = JaxDDN(num_classes=9, backbone_name="ResNet50")
    variables = jax_load(random_variables(jm, jnp.asarray(x), train=False),
                         sd)
    feats, logits = jax.device_get(jax.jit(lambda v, xx: jm.apply(
        v, xx, train=False))(to_jax(variables), jnp.asarray(x)))
    model = DeepLabV3DDN(9, "ResNet50", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    load_torchvision_deeplab(model, sd).eval()
    with torch.no_grad():
        got_f, got_l = model(torch.from_numpy(x))
    assert got_f.shape == (1, 9, 17, 256) and got_l.shape == (1, 9, 17, 9)
    assert_close(got_f.numpy(), feats, TOL, "layer1 features")
    assert_close(got_l.numpy(), logits, TOL, "depth logits")
    conv = convert_variables(variables, model)
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(conv[k].numpy(), t.numpy(), err_msg=k)


def test_deeplabv3_resnet101_structure():
    """ResNet101 differs from ResNet50 only in layer3's 23 blocks; the
    dilated stages keep stride 1 (output stride 8) and take the previous
    dilation in their first block."""
    from multimodal_gar_tpu_torch.detection.ddn_deeplab import (
        RESNET_LAYERS, DeepLabV3DDN)
    model = DeepLabV3DDN(81, "ResNet101", device="meta",
                         generator=torch.Generator().manual_seed(0))
    trunk = model.backbone
    for li, n in zip(range(1, 5), RESNET_LAYERS["ResNet101"]):
        assert sum(name.startswith(f"layer{li}_") for name, _ in
                   trunk.named_children()) == n
    assert RESNET_LAYERS["ResNet101"] == (3, 4, 23, 3)
    for name, stride, dil in (("layer3_0", 1, 1), ("layer3_1", 1, 2),
                              ("layer4_0", 1, 2), ("layer4_2", 1, 4),
                              ("layer2_0", 2, 1)):
        conv2 = getattr(trunk, name).conv2
        assert conv2.stride == (stride, stride), name
        assert conv2.dilation == (dil, dil), name
    assert model.aspp.b3_conv.dilation == (36, 36)
    assert model.cls_out.out_channels == 81
