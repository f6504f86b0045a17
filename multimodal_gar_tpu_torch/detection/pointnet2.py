"""PointNet++ MSG backbone for point-based detectors
(detection/pointnet2.py; pcdet pointnet2_backbone.py: PointNet2MSG, with
the pointnet2_batch modules it drives).

Four set-abstraction levels (FPS centres, multi-scale ball query and
grouping, shared MLP, max over the samples) and four feature-propagation
levels (three-NN inverse-distance interpolation + MLP) back to every
point; fixed point counts per level, invalid supports masked. The MLPs
are Linear -> BN -> ReLU stacks over (B, M, S, C), their training
statistics over every row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.neighbor import (ball_query, grouping_operation,
                            three_interpolate, three_nn)
from ..ops.sampling import farthest_point_sampling, gather_points
from .point_heads import add_dense_stack, run_dense_stack


@dataclasses.dataclass(frozen=True)
class PointNet2Config:
    """KITTI PointRCNN defaults (pointrcnn.yaml SA_CONFIG)."""
    npoints: Tuple[int, ...] = (4096, 1024, 256, 64)
    radii: Tuple[Tuple[float, ...], ...] = ((0.1, 0.5), (0.5, 1.0),
                                            (1.0, 2.0), (2.0, 4.0))
    nsamples: Tuple[Tuple[int, ...], ...] = ((16, 32), (16, 32), (16, 32),
                                             (16, 32))
    sa_mlps: Tuple[Tuple[Tuple[int, ...], ...], ...] = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)),
    )
    fp_mlps: Tuple[Tuple[int, ...], ...] = ((128, 128), (256, 256),
                                            (512, 512), (512, 512))
    use_xyz: bool = True


class SAModuleMSG(nn.Module):
    """One batched SA level: FPS centres + multi-scale group / MLP / max.
    ``cin``: the input features' channels (0: none)."""

    def __init__(self, cin: int, npoint: int, radii, nsamples, mlps,
                 use_xyz: bool = True, *, device, generator):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        self.mlps, self.use_xyz = mlps, use_xyz
        first = 3 if cin == 0 else (3 + cin if use_xyz else cin)
        for i, mlp in enumerate(mlps):
            add_dense_stack(self, first, mlp, f"mlp{i}", device=device,
                            generator=generator)

    @property
    def out_channels(self) -> int:
        return sum(m[-1] for m in self.mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                valid: torch.Tensor):
        """xyz (B, N, 3), features (B, N, C) or None, valid (B, N) ->
        (new_xyz (B, np, 3), new_feats (B, np, C'), new_valid (B, np))."""
        idx = farthest_point_sampling(xyz, self.npoint, valid)
        new_xyz = gather_points(xyz, idx)
        new_valid = torch.gather(valid, -1, idx)
        outs = []
        for i, (r, ns, mlp) in enumerate(zip(self.radii, self.nsamples,
                                             self.mlps)):
            nbr, empty = ball_query(r, ns, xyz, new_xyz, valid)
            g = grouping_operation(xyz, nbr) - new_xyz[..., None, :]
            if features is not None:
                gf = grouping_operation(features, nbr)
                g = torch.cat([g, gf], -1) if self.use_xyz else gf
            h = torch.amax(run_dense_stack(self, g, len(mlp), f"mlp{i}"),
                           dim=-2)
            outs.append(h * (~empty)[..., None].to(h.dtype))
        feats = torch.cat(outs, -1)
        return new_xyz, feats * new_valid[..., None].to(feats.dtype), \
            new_valid


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation of the
    known features at the unknown points, ++ the unknown points' own, and
    an MLP (``mlp_{i}``)."""

    def __init__(self, cin: int, mlp, *, device, generator):
        super().__init__()
        self.n = len(mlp)
        add_dense_stack(self, cin, mlp, "mlp", device=device,
                        generator=generator)

    def forward(self, unknown, known, unknown_feats, known_feats,
                known_valid):
        dist, idx = three_nn(unknown, known, known_valid)
        x = three_interpolate(known_feats, idx, dist)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], -1)
        return run_dense_stack(self, x, self.n, "mlp")


class PointNet2MSG(nn.Module):
    """The encoder-decoder over raw points -> per-point features
    (pointnet2_backbone.py:56-94). ``point_features``: the points'
    channels beyond xyz."""

    def __init__(self, cfg: PointNet2Config = PointNet2Config(),
                 point_features: int = 1, *, device, generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        ch = [point_features]
        for k in range(len(cfg.npoints)):
            sa = SAModuleMSG(ch[k], cfg.npoints[k], cfg.radii[k],
                             cfg.nsamples[k], cfg.sa_mlps[k], cfg.use_xyz,
                             **kw)
            self.add_module(f"sa{k}", sa)
            ch.append(sa.out_channels)
        known = ch[-1]
        for i in range(len(cfg.fp_mlps) - 1, -1, -1):
            self.add_module(f"fp{i}", FPModule(known + ch[i],
                                               cfg.fp_mlps[i], **kw))
            known = cfg.fp_mlps[i][-1]

    @property
    def out_channels(self) -> int:
        return self.cfg.fp_mlps[0][-1]

    def forward(self, points: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
        """points (B, N, 3 + C) -> (B, N, fp_mlps[0][-1]), zero on
        invalid points."""
        xyz = points[..., :3]
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_feats, l_valid = [xyz], [feats], [valid]
        for k in range(len(self.cfg.npoints)):
            nx, nf, nv = getattr(self, f"sa{k}")(l_xyz[k], l_feats[k],
                                                 l_valid[k])
            l_xyz.append(nx)
            l_feats.append(nf)
            l_valid.append(nv)
        for i in range(len(self.cfg.fp_mlps) - 1, -1, -1):
            l_feats[i] = getattr(self, f"fp{i}")(
                l_xyz[i], l_xyz[i + 1], l_feats[i], l_feats[i + 1],
                l_valid[i + 1])
        return l_feats[0] * valid[..., None].to(l_feats[0].dtype)
