"""Alternative 2D image backbones: the VGG16 / VGG19 and Inception-v3
feature stacks (models/backbones2d.py; reference model/backbone.py:7-96,
MyVGG16, MyVGG19 and MyInception_v3, inactive under mil3.yaml).

Written from ``torch.nn`` (no torchvision). Images come in and features go
out NHWC, as in the JAX package; the convolutions run NCHW inside, for
cuDNN. Module names follow the flax tree, so convert.py carries its weights
over. flax's "SAME" padding at stride 1 is the symmetric k // 2; its
``avg_pool(..., padding="SAME")`` counts the padding in the mean
(``count_include_pad=True``); its ``max_pool`` without padding is VALID.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, conv2d

# VGG configurations: channels per conv, "M" = 2 x 2 max pool
_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")
_VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

Pair = Union[int, Tuple[int, int]]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class VGGFeatures(nn.Module):
    """The VGG conv stack (torchvision vgg{16,19}.features): 3 x 3 convs
    with bias and ReLU, 2 x 2 max pools. NHWC (B, H, W, 3) -> [(B, H / 32,
    W / 32, 512)]."""

    def __init__(self, config: Sequence = _VGG16, in_channels: int = 3, *,
                 device, generator):
        super().__init__()
        self.config = tuple(config)
        cin, i = in_channels, 0
        for c in self.config:
            if c != "M":
                self.add_module(f"conv_{i}", conv2d(
                    cin, c, 3, padding=1, bias=True, device=device,
                    generator=generator))
                cin, i = c, i + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x, i = _nchw(x), 0
        for c in self.config:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
        return [_nhwc(x)]


def VGG16(*, device, generator) -> VGGFeatures:
    return VGGFeatures(_VGG16, device=device, generator=generator)


def VGG19(*, device, generator) -> VGGFeatures:
    return VGGFeatures(_VGG19, device=device, generator=generator)


class _ConvBN(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, momentum 0.99) + ReLU, NCHW;
    ``same``: stride-1 "SAME" padding, else VALID."""

    def __init__(self, cin: int, out: int, kernel: Pair = 3,
                 stride: Pair = 1, same: bool = False, *, device, generator):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        pad = (kh // 2, kw // 2) if same else 0
        self.conv = conv2d(cin, out, (kh, kw), stride, pad, device=device,
                           generator=generator)
        self.bn = BatchNorm(out, 1e-3, device=device, momentum=0.99,
                            channel_axis=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class _InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b1x1 = _ConvBN(cin, 64, 1, **kw)
        self.b5x5_1 = _ConvBN(cin, 48, 1, **kw)
        self.b5x5_2 = _ConvBN(48, 64, 5, same=True, **kw)
        self.b3x3dbl_1 = _ConvBN(cin, 64, 1, **kw)
        self.b3x3dbl_2 = _ConvBN(64, 96, 3, same=True, **kw)
        self.b3x3dbl_3 = _ConvBN(96, 96, 3, same=True, **kw)
        self.bpool = _ConvBN(cin, pool_features, 1, **kw)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([self.b1x1(x), b5, b3, bp], dim=1)


class _InceptionB(nn.Module):
    def __init__(self, cin: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b3x3 = _ConvBN(cin, 384, 3, 2, **kw)
        self.b3x3dbl_1 = _ConvBN(cin, 64, 1, **kw)
        self.b3x3dbl_2 = _ConvBN(64, 96, 3, same=True, **kw)
        self.b3x3dbl_3 = _ConvBN(96, 96, 3, 2, **kw)
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([self.b3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class _InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b1x1 = _ConvBN(cin, 192, 1, **kw)
        self.b7_1 = _ConvBN(cin, c7, 1, **kw)
        self.b7_2 = _ConvBN(c7, c7, (1, 7), same=True, **kw)
        self.b7_3 = _ConvBN(c7, 192, (7, 1), same=True, **kw)
        self.b7dbl_1 = _ConvBN(cin, c7, 1, **kw)
        self.b7dbl_2 = _ConvBN(c7, c7, (7, 1), same=True, **kw)
        self.b7dbl_3 = _ConvBN(c7, c7, (1, 7), same=True, **kw)
        self.b7dbl_4 = _ConvBN(c7, c7, (7, 1), same=True, **kw)
        self.b7dbl_5 = _ConvBN(c7, 192, (1, 7), same=True, **kw)
        self.bpool = _ConvBN(cin, 192, 1, **kw)
        self.out_channels = 4 * 192

    def forward(self, x):
        b7 = self.b7_3(self.b7_2(self.b7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"b7dbl_{i}")(bd)
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([self.b1x1(x), b7, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """Inception-v3 to Mixed_6e (MyInception_v3): NHWC (B, H, W, 3) ->
    [Mixed_5d (288 channels, stride 8), Mixed_6e (768, stride 16)], NHWC."""

    def __init__(self, in_channels: int = 3, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Conv2d_1a = _ConvBN(in_channels, 32, 3, 2, **kw)
        self.Conv2d_2a = _ConvBN(32, 32, 3, **kw)
        self.Conv2d_2b = _ConvBN(32, 64, 3, same=True, **kw)
        self.Conv2d_3b = _ConvBN(64, 80, 1, **kw)
        self.Conv2d_4a = _ConvBN(80, 192, 3, **kw)
        self.Mixed_5b = _InceptionA(192, 32, **kw)
        self.Mixed_5c = _InceptionA(256, 64, **kw)
        self.Mixed_5d = _InceptionA(288, 64, **kw)
        self.Mixed_6a = _InceptionB(288, **kw)
        self.Mixed_6b = _InceptionC(768, 128, **kw)
        self.Mixed_6c = _InceptionC(768, 160, **kw)
        self.Mixed_6d = _InceptionC(768, 160, **kw)
        self.Mixed_6e = _InceptionC(768, 192, **kw)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.Conv2d_2b(self.Conv2d_2a(self.Conv2d_1a(_nchw(x))))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a(self.Conv2d_3b(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = getattr(self, name)(x)
        out1 = x
        for name in ("Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e"):
            x = getattr(self, name)(x)
        return [_nhwc(out1), _nhwc(x)]
