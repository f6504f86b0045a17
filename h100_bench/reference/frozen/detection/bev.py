"""HeightCompression and BaseBEVBackbone (detection/bev.py), NCHW, with the
port's ``conv2d`` (models/layers.py: flax's default init). cuDNN runs the
convs at its default settings: the port's ``cudnn_autotuned`` only picks
faster algorithms."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from ..models.layers import LECUN, BatchNorm, draw
from ..models.sparse_backbone import SparseTensor


def conv2d(cin: int, cout: int, kernel, stride=1, padding=0,
           bias: bool = False, transposed: bool = False, dilation: int = 1,
           *, device, generator, bias_value: float = 0.0,
           std: Optional[float] = None) -> nn.Module:
    """nn.Conv2d (or ConvTranspose2d) with flax's default init: a normal
    kernel of variance 1 / (kh * kw * cin) (``std`` overrides it), bias
    ``bias_value``. ``kernel``, ``stride`` and ``padding`` are ints or
    (h, w) pairs."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    cls = nn.ConvTranspose2d if transposed else nn.Conv2d
    conv = skip_init(cls, cin, cout, (kh, kw), stride=stride, padding=padding,
                     dilation=dilation, bias=bias, device=device)
    if std is None:
        std = (LECUN / (kh * kw * cin)) ** 0.5
    with torch.no_grad():
        conv.weight.copy_(draw(conv.weight.shape, std, device=device,
                               generator=generator))
        if bias:
            conv.bias.fill_(bias_value)
    return conv



def sparse_to_dense_bev(st: SparseTensor) -> torch.Tensor:
    """SparseTensor (B, M, C) with zyx coords -> dense NCHW (B, D*C, H, W),
    depth folded d-major."""
    b, m, c = st.features.shape
    d, h, w = st.spatial_shape
    co = st.coords.long()
    flat = torch.where(st.valid, (co[..., 0] * h + co[..., 1]) * w
                       + co[..., 2], d * h * w)                # trash row
    dense = torch.zeros((b, d * h * w + 1, c), dtype=st.features.dtype,
                        device=st.features.device)
    dense = dense.scatter(1, flat[..., None].expand(-1, -1, c), st.features)
    dense = dense[:, :-1].reshape(b, d, h, w, c)
    return dense.permute(0, 1, 4, 2, 3).reshape(b, d * c, h, w)


class BaseBEVBackbone(nn.Module):
    """Multi-scale 2D conv trunk + upsample-concat FPN
    (base_bev_backbone.py:6-112), NCHW. Each block's first conv pads (1, 1)
    at its stride, the others are 3x3 at stride 1 ("SAME"); the deblocks
    are transposed convs of kernel = stride (flax ``ConvTranspose``, whose
    taps convert.py flips into torch's) or, for an upsample stride < 1,
    convs of kernel = stride = 1 / us. BatchNorm eps 1e-3, momentum 0.99."""

    def __init__(self, cin: int, layer_nums=(5, 5), layer_strides=(1, 2),
                 num_filters=(128, 256), upsample_strides=(1, 2),
                 num_upsample_filters=(256, 256), *, device, generator):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.upsample_strides = tuple(upsample_strides)
        kw = dict(device=device, generator=generator)

        def bn(ch):
            return BatchNorm(ch, 1e-3, device=device, momentum=0.99,
                             channel_axis=1)
        ch_in = cin
        ups_ch = 0
        for i, (n_lay, stride, ch) in enumerate(
                zip(layer_nums, layer_strides, num_filters)):
            self.add_module(f"block{i}_down_conv",
                            conv2d(ch_in, ch, 3, stride, 1, **kw))
            self.add_module(f"block{i}_down_bn", bn(ch))
            for k in range(n_lay):
                self.add_module(f"block{i}_l{k}_conv",
                                conv2d(ch, ch, 3, 1, 1, **kw))
                self.add_module(f"block{i}_l{k}_bn", bn(ch))
            ch_in = ch
            if self.upsample_strides:
                us = self.upsample_strides[i]
                cu = num_upsample_filters[i]
                if us >= 1:
                    self.add_module(f"deblock{i}_deconv", conv2d(
                        ch, cu, us, us, transposed=True, **kw))
                else:
                    s = int(round(1 / us))
                    self.add_module(f"deblock{i}_conv",
                                    conv2d(ch, cu, s, s, **kw))
                self.add_module(f"deblock{i}_bn", bn(cu))
                ups_ch += cu
            else:
                ups_ch = ch
        self.extra = len(self.upsample_strides) > len(self.layer_nums)
        if self.extra:
            us = self.upsample_strides[-1]
            self.deblock_extra = conv2d(ups_ch, ups_ch, us, us,
                                        transposed=True, **kw)
            self.deblock_extra_bn = bn(ups_ch)
        self.num_bev_features = ups_ch

    def _cbr(self, x, name):
        return F.relu(getattr(self, f"{name}_bn")(
            getattr(self, f"{name}_conv")(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for i, n_lay in enumerate(self.layer_nums):
            x = self._cbr(x, f"block{i}_down")
            for k in range(n_lay):
                x = self._cbr(x, f"block{i}_l{k}")
            if self.upsample_strides:
                up = getattr(self, f"deblock{i}_deconv", None) \
                    or getattr(self, f"deblock{i}_conv")
                ups.append(F.relu(getattr(self, f"deblock{i}_bn")(up(x))))
            else:
                ups.append(x)
        out = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if self.extra:
            out = F.relu(self.deblock_extra_bn(self.deblock_extra(out)))
        return out
