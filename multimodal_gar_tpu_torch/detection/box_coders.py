"""Box encode / decode between GT boxes and anchors or points
(detection/box_coders.py; pcdet utils/box_coder_utils.py): ResidualCoder,
PreviousResidualDecoder, PointResidualCoder, as pure functions of tensors.
Boxes are (..., 7+) = [x, y, z, dx, dy, dz, heading, ...]."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _split(x: torch.Tensor, n: int):
    return torch.split(x[..., :n], 1, dim=-1)


def _clamp_sizes(boxes: torch.Tensor) -> torch.Tensor:
    return torch.cat([boxes[..., :3], boxes[..., 3:6].clamp(min=1e-5),
                      boxes[..., 6:]], dim=-1)


@dataclasses.dataclass(frozen=True)
class ResidualCoder:
    """Anchor-relative residual coder (box_coder_utils.py:5-77)."""
    code_size: int = 7
    encode_angle_by_sincos: bool = False

    @property
    def full_code_size(self) -> int:
        return self.code_size + (1 if self.encode_angle_by_sincos else 0)

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor
               ) -> torch.Tensor:
        anchors, boxes = _clamp_sizes(anchors), _clamp_sizes(boxes)
        xa, ya, za, dxa, dya, dza, ra = _split(anchors, 7)
        xg, yg, zg, dxg, dyg, dzg, rg = _split(boxes, 7)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        rts = ([torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
               if self.encode_angle_by_sincos else [rg - ra])
        extras = [boxes[..., 7:] - anchors[..., 7:]] \
            if boxes.shape[-1] > 7 else []
        return torch.cat([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                          torch.log(dxg / dxa), torch.log(dyg / dya),
                          torch.log(dzg / dza), *rts, *extras], dim=-1)

    def decode(self, encodings: torch.Tensor, anchors: torch.Tensor
               ) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = _split(anchors, 7)
        if self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt, cost, sint = _split(encodings, 8)
            extras_in = encodings[..., 8:]
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            xt, yt, zt, dxt, dyt, dzt, rt = _split(encodings, 7)
            extras_in = encodings[..., 7:]
            rg = rt + ra
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        extras = [extras_in + anchors[..., 7:]] \
            if anchors.shape[-1] > 7 else []
        return torch.cat([xt * diag + xa, yt * diag + ya, zt * dza + za,
                          torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                          torch.exp(dzt) * dza, rg, *extras], dim=-1)


@dataclasses.dataclass(frozen=True)
class PreviousResidualDecoder:
    """Legacy decode with the (w, l, h) slot order (box_coder_utils.py:80)."""
    code_size: int = 7

    def decode(self, encodings: torch.Tensor, anchors: torch.Tensor
               ) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = _split(anchors, 7)
        xt, yt, zt, wt, lt, ht, rt = _split(encodings, 7)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.cat([xt * diag + xa, yt * diag + ya, zt * dza + za,
                          torch.exp(lt) * dxa, torch.exp(wt) * dya,
                          torch.exp(ht) * dza, rt + ra], dim=-1)


@dataclasses.dataclass(frozen=True)
class PointResidualCoder:
    """Point-relative coder with per-class mean sizes
    (box_coder_utils.py:144-222). The heading is always (cos, sin)."""
    code_size: int = 8
    use_mean_size: bool = True
    mean_size: Tuple[Tuple[float, float, float], ...] = (
        (3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))

    def _sizes_for(self, classes: torch.Tensor) -> torch.Tensor:
        ms = torch.tensor(self.mean_size, dtype=torch.float32,
                          device=classes.device)
        return ms[(classes.long() - 1).clamp(0, ms.shape[0] - 1)]

    def encode(self, gt_boxes: torch.Tensor, points: torch.Tensor,
               gt_classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        gt_boxes = _clamp_sizes(gt_boxes)
        xg, yg, zg, dxg, dyg, dzg, rg = _split(gt_boxes, 7)
        xa, ya, za = _split(points, 3)
        if self.use_mean_size:
            sz = self._sizes_for(gt_classes)
            dxa, dya, dza = sz[..., 0:1], sz[..., 1:2], sz[..., 2:3]
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            head = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                    torch.log(dxg / dxa), torch.log(dyg / dya),
                    torch.log(dzg / dza)]
        else:
            head = [xg - xa, yg - ya, zg - za, torch.log(dxg),
                    torch.log(dyg), torch.log(dzg)]
        return torch.cat([*head, torch.cos(rg), torch.sin(rg),
                          gt_boxes[..., 7:]], dim=-1)

    def decode(self, encodings: torch.Tensor, points: torch.Tensor,
               pred_classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        xt, yt, zt, dxt, dyt, dzt, cost, sint = _split(encodings, 8)
        xa, ya, za = _split(points, 3)
        if self.use_mean_size:
            sz = self._sizes_for(pred_classes)
            dxa, dya, dza = sz[..., 0:1], sz[..., 1:2], sz[..., 2:3]
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            head = [xt * diag + xa, yt * diag + ya, zt * dza + za,
                    torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                    torch.exp(dzt) * dza]
        else:
            head = [xt + xa, yt + ya, zt + za, torch.exp(dxt),
                    torch.exp(dyt), torch.exp(dzt)]
        return torch.cat([*head, torch.atan2(sint, cost),
                          encodings[..., 8:]], dim=-1)
