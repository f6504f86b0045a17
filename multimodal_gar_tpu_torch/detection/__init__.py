"""Port of multimodal_gar_tpu/detection: the detector zoo (SECOND,
PointPillar, PillarNet, CenterPoint, VoxelRCNN-Det, PV-RCNN, SECONDNetIoU,
PartA2, PointRCNN, VoxelNeXt, PV-RCNN++, CaDDN, MPPNet, MPPNetE2E) with its
anchors, box coders, target assignment, BEV and sparse trunks, point,
dense and RoI heads, the zoo's extra modules (extras.py), post-processing
and train step."""
from .detectors import (DetBatch, DetectorConfig, available_detectors,
                        build_detector, default_config)
from .post import NMSConfig, post_processing
# importing the families registers them
from . import roi_detectors as _roi_detectors
from . import parta2 as _parta2
from . import point_rcnn as _point_rcnn
from . import voxelnext as _voxelnext
from . import pv_rcnn_pp as _pv_rcnn_pp
from . import caddn as _caddn
from . import mppnet as _mppnet

__all__ = ["DetBatch", "DetectorConfig", "available_detectors",
           "build_detector", "default_config", "NMSConfig",
           "post_processing"]
