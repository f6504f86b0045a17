"""RoIAlign as two per-ROI interpolation matrices (ops/roi_align.py).

torchvision.ops.roi_align semantics as used by the reference (output 5x5,
spatial_scale = W_f / W, sampling_ratio=-1, aligned=False): a static grid of
``max_samples`` samples per bin and axis, masked down to the adaptive count
ceil(bin_size), and separable bilinear weights, so each ROI is
``Ay @ F @ Ax^T``. The boxes and the weights are computed in the features'
dtype, as the JAX package computes them (bf16 features: every step rounded
to bf16, ``spatial_scale`` too, as JAX rounds a weakly typed Python
number).
"""
from __future__ import annotations

import torch


def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor,
                  grid_n: torch.Tensor, out_size: int, max_samples: int,
                  dim: int) -> torch.Tensor:
    """(..., out_size, dim) interpolation matrix of one axis per ROI."""
    dt, dev = bin_size.dtype, bin_size.device
    o = torch.arange(out_size, dtype=dt, device=dev)[:, None]     # (out, 1)
    i = torch.arange(max_samples, dtype=dt, device=dev)[None, :]  # (1, S)
    start, bin_size, grid_n = (v[..., None, None]
                               for v in (start, bin_size, grid_n))
    pos = start + o * bin_size + (i + 0.5) * bin_size / grid_n    # (.., o, S)
    valid = (i < grid_n) & (pos >= -1.0) & (pos <= dim)
    pos_c = torch.clamp(pos, 0.0, dim - 1.0)
    grid = torch.arange(dim, dtype=dt, device=dev)
    w = torch.clamp(1.0 - torch.abs(pos_c[..., None] - grid), min=0.0)
    w = w * valid[..., None].to(dt)
    return torch.sum(w, dim=-2) / grid_n                       # (.., out, dim)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, out_size: int = 5,
              spatial_scale: float = 1.0, max_samples: int = 4
              ) -> torch.Tensor:
    """RoIAlign over a batch of feature maps.

    Args:
      features: (B, C, H, W).
      boxes: (B, N, 4) xyxy boxes in input-image coordinates.
    Returns:
      (B, N, C, out_size, out_size).
    """
    _, _, h, w = features.shape
    boxes = boxes.to(features.dtype)
    if features.dtype == torch.bfloat16:
        spatial_scale = torch.tensor(spatial_scale, dtype=features.dtype)
    x1, y1, x2, y2 = (boxes[..., k] * spatial_scale for k in range(4))
    roi_w = torch.clamp(x2 - x1, min=1.0)          # aligned=False legacy clamp
    roi_h = torch.clamp(y2 - y1, min=1.0)
    bin_w = roi_w / out_size
    bin_h = roi_h / out_size
    gw = torch.clamp(torch.ceil(bin_w), 1, max_samples)
    gh = torch.clamp(torch.ceil(bin_h), 1, max_samples)
    ay = _axis_weights(y1, bin_h, gh, out_size, max_samples, h)  # (B,N,out,H)
    ax = _axis_weights(x1, bin_w, gw, out_size, max_samples, w)  # (B,N,out,W)
    tmp = torch.einsum("bnoh,bchw->bnocw", ay, features)
    return torch.einsum("bnocw,bnmw->bncom", tmp, ax)
