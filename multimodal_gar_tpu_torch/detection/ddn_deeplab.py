"""DeepLabV3 + ResNet depth-distribution network of CaDDN
(detection/ddn_deeplab.py; pcdet ddn_deeplabv3.py + ddn_template.py,
built from torchvision's deeplabv3_resnet{50,101}), written from
``torch.nn`` (no torchvision).

- the ResNet v1 trunk: a 7 x 7 / 2 stem and a 3 x 3 / 2 max pool (padded
  with -inf), bottleneck stages [3, 4, 6 | 23, 3] with layer3 at dilation
  2 and layer4 at dilation 4 (output stride 8); the first block of a
  dilated stage takes the previous dilation for its 3 x 3, as torchvision
  builds it;
- the features are the layer1 tap (stride 4, 256 channels);
- the classifier is DeepLabHead: ASPP (1 x 1, rates 12 / 24 / 36 and
  image pooling, 256 channels each, projected to 256, dropout 0.5), a
  3 x 3 conv + BN + ReLU and a 1 x 1 conv to the depth bins, upsampled
  bilinearly (align_corners False) to the layer1 map's size.

Images come in NHWC in [0, 1] and both outputs go out NHWC, as in the JAX
package; the convolutions run NCHW inside. BatchNorm eps 1e-5, momentum
0.9. ``load_torchvision_deeplab`` loads a torchvision-format state dict by
its key names.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, Dropout, conv2d

RESNET_LAYERS = {"ResNet50": (3, 4, 6, 3), "ResNet101": (3, 4, 23, 3)}
# (planes, stride, dilation) of layer1..layer4
_STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _bn(ch: int, device) -> BatchNorm:
    return BatchNorm(ch, 1e-5, device=device, momentum=0.9, channel_axis=1)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1 x 1 -> 3 x 3 (stride, dilation) -> 1 x 1
    to 4 x planes, the shortcut a strided 1 x 1 + BN where ``downsample``."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = conv2d(cin, planes, 1, **kw)
        self.bn1 = _bn(planes, device)
        self.conv2 = conv2d(planes, planes, 3, stride, dilation,
                            dilation=dilation, **kw)
        self.bn2 = _bn(planes, device)
        self.conv3 = conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = _bn(planes * 4, device)
        if downsample:
            self.down_conv = conv2d(cin, planes * 4, 1, stride, **kw)
            self.down_bn = _bn(planes * 4, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class ResNetDeepLabTrunk(nn.Module):
    """ResNet v1 at output stride 8. NCHW -> (layer1 features, layer4
    features)."""

    def __init__(self, layers: Tuple[int, int, int, int], *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.layers = tuple(layers)
        self.conv1 = conv2d(3, 64, 7, 2, 3, **kw)
        self.bn1 = _bn(64, device)
        cin = 64
        for li, ((planes, stride, dil), blocks) in enumerate(
                zip(_STAGES, self.layers), start=1):
            for bi in range(blocks):
                first = bi == 0
                d = max(dil // (2 if first and dil > 1 else 1), 1)
                self.add_module(f"layer{li}_{bi}", Bottleneck(
                    cin, planes, stride if first else 1, d, first, **kw))
                cin = planes * 4

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = None
        for li, blocks in enumerate(self.layers, start=1):
            for bi in range(blocks):
                x = getattr(self, f"layer{li}_{bi}")(x)
            if li == 1:
                feats = x
        return feats, x


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling, NCHW: 1 x 1, three dilated 3 x 3 and
    an image-pooling branch (global mean, 1 x 1, broadcast back), each
    conv + BN + ReLU, concatenated and projected, then dropout 0.5."""

    def __init__(self, cin: int = 2048, out_channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36), *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.rates = tuple(rates)
        self.b0_conv = conv2d(cin, out_channels, 1, **kw)
        self.b0_bn = _bn(out_channels, device)
        for i, r in enumerate(self.rates, start=1):
            self.add_module(f"b{i}_conv", conv2d(cin, out_channels, 3, 1, r,
                                                 dilation=r, **kw))
            self.add_module(f"b{i}_bn", _bn(out_channels, device))
        self.pool_conv = conv2d(cin, out_channels, 1, **kw)
        self.pool_bn = _bn(out_channels, device)
        self.proj_conv = conv2d(out_channels * (len(self.rates) + 2),
                                out_channels, 1, **kw)
        self.proj_bn = _bn(out_channels, device)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(self.b0_bn(self.b0_conv(x)))]
        for i in range(1, len(self.rates) + 1):
            branches.append(F.relu(getattr(self, f"b{i}_bn")(
                getattr(self, f"b{i}_conv")(x))))
        g = F.relu(self.pool_bn(self.pool_conv(x.mean((2, 3), keepdim=True))))
        branches.append(g.expand_as(branches[0]))
        y = F.relu(self.proj_bn(self.proj_conv(torch.cat(branches, 1))))
        return self.dropout(y)


class DeepLabV3DDN(nn.Module):
    """DDNDeepLabV3: images (B, H, W, 3) in [0, 1] -> (features (B, Hf, Wf,
    256), logits (B, Hf, Wf, num_classes)) at the layer1 resolution."""

    def __init__(self, num_classes: int, backbone_name: str = "ResNet101",
                 *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.backbone = ResNetDeepLabTrunk(RESNET_LAYERS[backbone_name], **kw)
        self.aspp = ASPP(**kw)
        self.cls_conv = conv2d(256, 256, 3, 1, 1, **kw)
        self.cls_bn = _bn(256, device)
        self.cls_out = conv2d(256, num_classes, 1, bias=True, **kw)

    def forward(self, images: torch.Tensor):
        # DDNTemplate.preprocess: ImageNet normalisation, padded (zero)
        # pixels kept at zero
        mean = images.new_tensor(IMAGENET_MEAN)
        std = images.new_tensor(IMAGENET_STD)
        x = torch.where(images == 0, 0.0, (images - mean) / std)
        feats, out = self.backbone(x.permute(0, 3, 1, 2))
        y = F.relu(self.cls_bn(self.cls_conv(self.aspp(out))))
        logits = F.interpolate(self.cls_out(y), size=feats.shape[-2:],
                               mode="bilinear", align_corners=False)
        return feats.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)


def _torchvision_keys(model: DeepLabV3DDN) -> dict:
    """The port's state_dict key -> torchvision deeplabv3_resnet* key."""
    pairs = {}

    def conv(port, tv):
        pairs[f"{port}.weight"] = f"{tv}.weight"

    def bn(port, tv):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            pairs[f"{port}.{leaf}"] = f"{tv}.{leaf}"
    conv("backbone.conv1", "backbone.conv1")
    bn("backbone.bn1", "backbone.bn1")
    for li, blocks in enumerate(model.backbone.layers, start=1):
        for bi in range(blocks):
            p, t = f"backbone.layer{li}_{bi}", f"backbone.layer{li}.{bi}"
            for n in (1, 2, 3):
                conv(f"{p}.conv{n}", f"{t}.conv{n}")
                bn(f"{p}.bn{n}", f"{t}.bn{n}")
            if bi == 0:
                conv(f"{p}.down_conv", f"{t}.downsample.0")
                bn(f"{p}.down_bn", f"{t}.downsample.1")
    for i in range(len(model.aspp.rates) + 1):
        conv(f"aspp.b{i}_conv", f"classifier.0.convs.{i}.0")
        bn(f"aspp.b{i}_bn", f"classifier.0.convs.{i}.1")
    pool = len(model.aspp.rates) + 1
    conv("aspp.pool_conv", f"classifier.0.convs.{pool}.1")
    bn("aspp.pool_bn", f"classifier.0.convs.{pool}.2")
    conv("aspp.proj_conv", "classifier.0.project.0")
    bn("aspp.proj_bn", "classifier.0.project.1")
    conv("cls_conv", "classifier.1")
    bn("cls_bn", "classifier.2")
    conv("cls_out", "classifier.4")
    pairs["cls_out.bias"] = "classifier.4.bias"
    return pairs


def load_torchvision_deeplab(model: DeepLabV3DDN,
                             state_dict: Mapping) -> DeepLabV3DDN:
    """Load a torchvision deeplabv3_resnet{50,101} state dict (tensors or
    numpy arrays under torchvision's key names; its aux classifier and
    num_batches_tracked are not read) into ``model`` in place, as the
    reference loads it (ddn_template.py:60-83). Raises KeyError for a key
    the dict lacks and ValueError for a shape mismatch."""
    own = model.state_dict()
    new = {}
    for port_key, tv_key in _torchvision_keys(model).items():
        if tv_key not in state_dict:
            raise KeyError(f"{tv_key} (for {port_key}) is not in the state "
                           "dict")
        t = torch.as_tensor(np.asarray(state_dict[tv_key]))
        if tuple(t.shape) != tuple(own[port_key].shape):
            raise ValueError(f"{tv_key}: {tuple(t.shape)} vs "
                             f"{tuple(own[port_key].shape)}")
        new[port_key] = t.to(own[port_key])
    model.load_state_dict(new, strict=True)
    return model
