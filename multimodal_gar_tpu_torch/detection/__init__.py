"""Port of multimodal_gar_tpu/detection: the detector zoo's first slice
(SECOND, PointPillar, PillarNet, CenterPoint, VoxelRCNN-Det) with its
anchors, box coders, target assignment, BEV trunks, dense and RoI heads,
post-processing and train step."""
from .detectors import (DetBatch, DetectorConfig, available_detectors,
                        build_detector, default_config)
from .post import NMSConfig, post_processing
from . import roi_detectors as _roi_detectors   # registers VoxelRCNN-Det

__all__ = ["DetBatch", "DetectorConfig", "available_detectors",
           "build_detector", "default_config", "NMSConfig",
           "post_processing"]
