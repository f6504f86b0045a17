"""The port's legacy grouping models (GARNet, TranSG, ActBaseline) against
the JAX package's, and the model registry.

Same numpy-seeded inputs, the JAX module's weights drawn with numpy and
carried through the converter; every output agrees to 1e-4 of its largest
reference value (float32, sums in other orders; TranSG through two
attention layers). A row of padded actors in the mask must come out zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.models.legacy import ActBaseline as JaxActBaseline
from multimodal_gar_tpu.models.legacy import GARNet as JaxGARNet
from multimodal_gar_tpu.models.legacy import TranSG as JaxTranSG
from multimodal_gar_tpu.models.registry import (
    available_models as jax_available_models)
from multimodal_gar_tpu_torch.models import (MGAR, available_models,
                                             build_model)
from multimodal_gar_tpu_torch.models.legacy import (ActBaseline, GARNet,
                                                    TranSG)
from multimodal_gar_tpu_torch.models.registry import DETECTOR_NAMES
from multimodal_gar_tpu_torch.utils.testing import tiny_config
from tests.test_torch_common import (assert_close, port_module,
                                     random_variables, to_jax)

TOL = 1e-4
B, N = 2, 6


def _inputs(d, box_scale, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, N, d)).astype(np.float32)
    xy = rng.uniform(0, box_scale, (B, N, 2))
    wh = rng.uniform(0.2, 0.5, (B, N, 2)) * box_scale
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.array([[True] * 5 + [False], [True] * 6])
    return feats, boxes, valid


def _compare(jmod, cls, args, kwargs=None):
    """Run the JAX module and the port's on ``args`` (numpy); returns the
    port's outputs, flattened, after holding each to the JAX one."""
    jargs = [jnp.asarray(a) for a in args]
    variables = random_variables(jmod, *jargs, seed=1)
    ref = jax.jit(jmod.apply)(to_jax(variables), *jargs)
    mod = port_module(cls, variables=variables, **(kwargs or {}))
    with torch.no_grad():
        got = mod(*[torch.from_numpy(a) for a in args])
    ref_flat = jax.tree_util.tree_leaves(ref)
    got_flat = jax.tree_util.tree_leaves(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert len(got_flat) == len(ref_flat)
    for i, (g, r) in enumerate(zip(got_flat, ref_flat)):
        assert_close(g.numpy(), r, TOL, f"output {i}")
        assert float(np.abs(np.asarray(r)).max()) > 0
    return got_flat


def test_garnet_matches_jax():
    feats, boxes, valid = _inputs(64, 50.0)
    gids = np.array([[0, 0, 1, 1, 2, 5], [0, 1, 1, 3, 3, 3]], np.int32)
    got = _compare(JaxGARNet(feature_dim=64), GARNet,
                   (feats, boxes, gids, valid), dict(feature_dim=64))
    d_sim = got[0]
    assert d_sim.shape == (B, N, N) and not d_sim[0, 5].any()
    assert [t.shape[-1] for t in got[1:]] == [4, 4, 4, 2, 4, 7, 5]


def test_transg_matches_jax():
    feats, boxes, valid = _inputs(64, 1.0)
    (adj,) = _compare(JaxTranSG(d_model=64, nhead=4, num_layers=2,
                                out_feature_dim=32), TranSG,
                      (feats, boxes, valid),
                      dict(d_model=64, nhead=4, num_layers=2,
                           out_feature_dim=32))
    assert adj.shape == (B, N, N) and not adj[0, 5].any()


def test_act_baseline_matches_jax():
    feats, boxes, valid = _inputs(32, 50.0)
    (adj,) = _compare(JaxActBaseline(mlp_widths=(2, 16, 8, 1)), ActBaseline,
                      (feats, boxes, valid), dict(mlp_widths=(2, 16, 8, 1)))
    assert adj.shape == (B, N, N) and not adj[0, 5].any()


def test_registry_builds_every_model_of_the_jax_registry():
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fusion=dataclasses.replace(cfg.model.fusion,
                                              feature_dim=64)))
    assert available_models() == jax_available_models()
    built = {}
    for name in available_models():
        # MGAR through the default name
        built[name] = build_model(cfg, *([name] if name != "MGAR" else []),
                                  device="cpu")
        assert type(built[name]).__name__ == name
        assert all(p.device.type == "cpu" for p in built[name].parameters())
    assert isinstance(built["MGAR"], MGAR)
    assert built["GARNet"].pose_0.Dense_0.in_features == 128
    with pytest.raises(KeyError):
        build_model(cfg, "nope", device="cpu")
    # the zoo's last families build too (every detector name:
    # tests/test_torch_detectors.py)
    for name in ("CaDDN", "MPPNet", "MPPNetE2E"):
        assert name in DETECTOR_NAMES
        model = build_model(cfg, name, device="cpu")
        assert model.cfg.name == name
        assert all(p.device.type == "cpu" for p in model.parameters())
