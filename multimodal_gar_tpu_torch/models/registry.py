"""Model registry and config-driven builder (models/registry.py): a name
maps to a constructor of the port's module from a Config, so drivers stay
model-agnostic. The seven names of the JAX registry are here, and as in the
JAX builder a detector name falls through to the detector zoo
(detection/, all 18 names of DETECTOR_NAMES), with
``cfg.data.point_cloud``'s range and voxel size threaded into the
detector's default config.

Every builder takes the module's ``device`` (the card unless the caller
asks for ``"cpu"``) and a ``generator`` for the weights.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..config import Config
from ..utils.device import resolve_device

_REGISTRY: Dict[str, Callable] = {}

# the JAX package's detector zoo (detection/: register_detector)
DETECTOR_NAMES = frozenset({
    "CaDDN", "CenterPoint", "MPPNet", "MPPNetE2E", "PV-RCNN", "PV-RCNN++",
    "PVRCNN", "PVRCNNPlusPlus", "PartA2", "PartA2Net", "PillarNet",
    "PointPillar", "PointRCNN", "SECOND", "SECONDNet", "SECONDNetIoU",
    "VoxelNeXt", "VoxelRCNN-Det"})


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_models():
    return sorted(_REGISTRY)


def build_model(cfg: Config, name: str = "MGAR", *, device="cuda",
                generator: Optional[torch.Generator] = None,
                det_cfg=None, **det_kw):
    """The module registered as ``name`` for ``cfg``, on ``device``, its
    weights drawn from ``generator`` (a CPU generator, seed 0 by
    default). A detector takes ``det_cfg`` (a DetectorConfig; the name's
    default config if None) with ``cfg``'s point-cloud geometry, and passes
    ``det_kw`` (a family's own configs, such as VoxelRCNN-Det's ``roi_cfg``
    and ``lidar_cfg``) to its constructor."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if name in _REGISTRY:
        return _REGISTRY[name](cfg, device=resolve_device(device),
                               generator=generator)
    if name in DETECTOR_NAMES:
        from ..detection import build_detector
        from ..detection.detectors import default_config
        # the caller's point-cloud geometry drives the anchor grid and the
        # sparse shape, as in the JAX builder, and its point width the first
        # layer's (flax infers it from the batch)
        pc = cfg.data.point_cloud
        det_cfg = dataclasses.replace(
            det_cfg or default_config(name),
            point_cloud_range=tuple(pc.range),
            voxel_size=tuple(pc.voxel.voxel_size))
        return build_detector(name, det_cfg,
                              in_channels=pc.num_point_features,
                              device=device, generator=generator, **det_kw)
    raise KeyError(f"unknown model {name!r}; have {available_models()} "
                   f"+ detectors {sorted(DETECTOR_NAMES)}")


@register("MGAR")
def _build_mgar(cfg: Config, **kw):
    from .mgar import MGAR
    return MGAR(cfg, **kw)


@register("GARFusionNet")
def _build_fusion_net(cfg: Config, **kw):
    from .mgar import GARFusionNet
    return GARFusionNet(cfg.model, **kw)


@register("RGBBackbone")
def _build_rgb(cfg: Config, **kw):
    from .rgb_backbone import RGBBackbone
    return RGBBackbone(cfg.model.rgb, **kw)


@register("LiDARBackbone")       # VoxelRCNN as a feature extractor
def _build_lidar(cfg: Config, **kw):
    from .lidar_backbone import LiDARBackbone
    return LiDARBackbone(cfg.model.lidar, cfg.data.point_cloud, **kw)


@register("GARNet")
def _build_garnet(cfg: Config, **kw):
    from .legacy import GARNet
    return GARNet(feature_dim=cfg.model.fusion.feature_dim, **kw)


@register("TranSG")
def _build_transg(cfg: Config, **kw):
    from .legacy import TranSG
    return TranSG(**kw)


@register("ActBaseline")
def _build_act_baseline(cfg: Config, **kw):
    from .legacy import ActBaseline
    return ActBaseline(**kw)
