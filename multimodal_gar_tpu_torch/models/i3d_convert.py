"""Load torch I3D (Kinetics ``rgb_imagenet.pt``-style) weights into the
port's InceptionI3d (models/i3d_convert.py).

The reference loads Kinetics-pretrained I3D weights into its torch backbone
(gat_model.py:987-991). The checkpoint is a torch state dict under the
published names, and the port's InceptionI3d names its tensors the same way
and keeps the same layouts, so a key lands on itself:

  <EP>.conv3d.weight (O,I,kt,kh,kw)       -> <EP>.conv3d.weight
  <EP>.bn.{weight,bias}                   -> <EP>.bn.{weight,bias}
  <EP>.bn.running_{mean,var}              -> <EP>.bn.running_{mean,var}
  Mixed_*.{b0,b1a,b1b,b2a,b2b,b3b}.*      -> nested the same way

(the stem keeps its 7x7x7 weight at Conv3d_1a_7x7.conv3d.weight; its
space-to-depth form is made in the forward). Same rules as the JAX
package's loader: endpoints deeper than the model's and ``logits`` are
dropped, ``num_batches_tracked`` is ignored, a shape mismatch raises, and a
checkpoint that matches no parameter raises.

Usage: load_i3d_checkpoint(model, path_or_state_dict)
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import torch

# leaves the converter deliberately ignores (torch BN bookkeeping buffers)
IGNORED_LEAVES = ("num_batches_tracked",)

_CONV_LEAVES = ("weight", "bias")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _split_key(name: str):
    """'Mixed_4f.b1a.conv3d.weight' -> (['Mixed_4f', 'b1a'], 'conv3d',
    'weight')"""
    parts = name.split(".")
    return parts[:-2], parts[-2], parts[-1]


def _mapped(layer: str, leaf: str) -> bool:
    return (layer == "conv3d" and leaf in _CONV_LEAVES) \
        or (layer == "bn" and leaf in _BN_LEAVES)


def unconsumed_keys(state_dict: Mapping[str, Any]) -> list:
    """Checkpoint keys convert_state_dict neither maps nor deliberately
    ignores — non-empty means the checkpoint contains naming this converter
    does not understand."""
    out = []
    for name in state_dict:
        _scope, layer, leaf = _split_key(name)
        if leaf not in IGNORED_LEAVES and not _mapped(layer, leaf):
            out.append(name)
    return out


def convert_state_dict(state_dict: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """The checkpoint's mapped tensors under the port's InceptionI3d keys
    (conv3d weights and biases, BatchNorm scales, biases and statistics);
    everything else is dropped."""
    out: Dict[str, torch.Tensor] = {}
    for name, tensor in state_dict.items():
        _scope, layer, leaf = _split_key(name)
        if _mapped(layer, leaf):
            out[name] = torch.as_tensor(tensor)     # tensors and numpy alike
    return out


def _overlay(i3d: torch.nn.Module, converted: Mapping[str, torch.Tensor]
             ) -> int:
    """Copy the converted tensors whose key the I3D has; returns how many
    parameters (not statistics) were copied, raises on a shape mismatch."""
    own = i3d.state_dict()
    params = {k for k, _ in i3d.named_parameters()}
    n = 0
    with torch.no_grad():
        for key, value in converted.items():
            if key not in own:
                continue                  # deeper endpoint, logits, conv bias
            cur = own[key]
            if tuple(cur.shape) != tuple(value.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{tuple(cur.shape)} vs {tuple(value.shape)}")
            cur.copy_(value.to(dtype=cur.dtype))
            n += key in params
    return n


def load_i3d_checkpoint(model: torch.nn.Module,
                        checkpoint: Union[str, Mapping],
                        scope: str = "rgb_backbone") -> torch.nn.Module:
    """Overlay converted I3D weights onto ``model`` in place.

    Args:
      model: a module holding the I3D at ``<scope>.i3d`` (``i3d`` when
        ``scope`` is empty), e.g. the port's MGAR.
      checkpoint: path to a torch .pt file or an in-memory state dict.
    """
    if isinstance(checkpoint, str):
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    else:
        state = checkpoint
    holder = model.get_submodule(scope) if scope else model
    if _overlay(holder.i3d, convert_state_dict(state)) == 0:
        raise ValueError("no I3D parameters matched the checkpoint")
    return model
