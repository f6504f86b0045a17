"""Port of multimodal_gar_tpu/models: MGAR, its fusion net, the legacy
grouping models and the registry that builds any of them by name."""
from .mgar import MGAR, GARFusionNet
from .registry import available_models, build_model, register

__all__ = ["MGAR", "GARFusionNet", "available_models", "build_model",
           "register"]
