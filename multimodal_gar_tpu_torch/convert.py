"""JAX package variables -> the port's state_dict.

Takes the ``{"params": ..., "batch_stats": ...}`` tree of
``multimodal_gar_tpu`` (nested dicts with numpy leaves) and returns a
state_dict for the port's module of the same name. The port names its
modules as the flax tree does, so a flax path ``a/b/kernel`` lands on
``a.b.weight``. Leaves map by kind:

  Dense kernel (in, out)           -> Linear.weight (out, in)
  conv kernel DHWIO                -> weight OIDHW (the stem's 7^3 kernel
                                      included, kept at Conv3d_1a_7x7/conv3d)
  2D conv kernel HWIO              -> Conv2d weight OIHW
  ConvTranspose kernel HWIO        -> ConvTranspose2d weight IOHW with the
                                      taps flipped (flax's transposed conv
                                      without transpose_kernel correlates
                                      the dilated input with the kernel as
                                      it is; torch's is the gradient of a
                                      conv, with the kernel flipped)
  sparse conv kernel (27, Cin, Cout) -> weight, unchanged
  BatchNorm / LayerNorm scale, bias -> weight, bias
  BatchNorm mean, var (batch_stats) -> running_mean, running_var
  raw weights used as x @ W        -> unchanged: WQ / WK / WV of the DAFM
                                      streams, WQ_r ... WV_l of the
                                      positional layers, WQ_0 ... of the
                                      MMCA layers
  GATv2 ``att`` (H, D)             -> unchanged
  TranSG ``group_token`` (T, D)    -> unchanged
  multi-head attention (flax MultiHeadDotProductAttention under
  ``query`` / ``key`` / ``value`` / ``out``):
    kernel (D, H, D/H), bias (H, D/H) -> Linear weight (H D/H, D), bias
    out kernel (H, D/H, D)            -> Linear weight (D, H D/H)

MaskedBatchNorm nests an auto-named BatchNorm_0 in flax; the port's
MaskedBatchNorm is that BatchNorm, so the segment is dropped. The converter
raises on any leaf it cannot place and on any port tensor left unfilled.

``export_variables`` goes the other way for the detectors' leaf kinds.
``convert_optimizer_state`` does the same for the optimizer leaves of the
JAX train state (Adam moments, the MultiSteps accumulator and the counts),
giving an ``AccumulatingAdam.load_state_dict`` input.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_DROP_SEGMENTS = ("BatchNorm_0",)
# the projections of flax's MultiHeadDotProductAttention, by module name:
# their rank-3 kernels are no sparse convs
_MHA_IN, _MHA_OUT = ("query", "key", "value"), "out"
_RAW_WEIGHT = re.compile(r"W[QKV](_(r|l|\d+))?|att|group_token")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _target(collection: str, path: Tuple[str, ...], leaf: np.ndarray
            ) -> Tuple[str, np.ndarray]:
    """(port key, array in the port's layout) of one flax leaf."""
    *mods, name = (p for p in path if p not in _DROP_SEGMENTS)
    prefix = "".join(f"{m}." for m in mods)
    if collection == "batch_stats":
        new = {"mean": "running_mean", "var": "running_var"}.get(name)
        if new is None:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        return f"{prefix}{new}", leaf
    module = mods[-1] if mods else ""
    if name == "kernel" and leaf.ndim == 3 and module in _MHA_IN:
        return f"{prefix}weight", leaf.reshape(leaf.shape[0], -1).T
    if name == "kernel" and leaf.ndim == 3 and module == _MHA_OUT:
        return f"{prefix}weight", leaf.reshape(-1, leaf.shape[-1]).T
    if name == "bias" and leaf.ndim == 2 and module in _MHA_IN:
        return f"{prefix}bias", leaf.reshape(-1)
    if name == "kernel":
        if leaf.ndim == 2:                               # Dense (in, out)
            return f"{prefix}weight", leaf.T
        if leaf.ndim == 5:                               # conv DHWIO
            return f"{prefix}weight", leaf.transpose(4, 3, 0, 1, 2)
        if leaf.ndim == 4:                               # 2D conv HWIO
            return f"{prefix}weight", leaf.transpose(3, 2, 0, 1)
        if leaf.ndim == 3:                               # sparse (27, Ci, Co)
            return f"{prefix}weight", leaf
        raise KeyError(f"kernel of rank {leaf.ndim} at {'/'.join(path)}")
    if name == "scale":
        return f"{prefix}weight", leaf
    if name == "bias" or _RAW_WEIGHT.fullmatch(name):
        return f"{prefix}{name}", leaf
    raise KeyError(f"unknown param leaf {'/'.join(path)}")


def convert_variables(variables: Mapping, model: torch.nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """state_dict for ``model`` from the flax ``variables`` tree.

    Raises KeyError for a leaf with no place in ``model`` (or placed twice),
    ValueError for a shape mismatch and for port tensors left unfilled.
    """
    expected = model.state_dict()
    transposed = {f"{name}.weight" for name, mod in model.named_modules()
                  if isinstance(mod, torch.nn.ConvTranspose2d)}
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key, arr = _target(collection, path, leaf)
            if key in transposed and leaf.ndim == 4:
                # order "C" gives fresh strides (ascontiguousarray keeps a
                # flipped size-1 axis's negative one)
                arr = np.array(leaf[::-1, ::-1].transpose(2, 3, 0, 1),
                               order="C")
            if key not in expected:
                raise KeyError(f"{collection}/{'/'.join(path)} -> {key}: no "
                               "such tensor in the port")
            if key in out:
                raise KeyError(f"{key} filled twice")
            ref = expected[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: flax {arr.shape} vs port "
                                 f"{tuple(ref.shape)}")
            out[key] = torch.from_numpy(np.array(arr, order="C")).to(
                dtype=ref.dtype, device=ref.device)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"port tensors not filled by the flax tree: "
                         f"{missing}")
    return out


def export_variables(model: torch.nn.Module) -> Dict[str, dict]:
    """The inverse of ``convert_variables`` for models of Linear, Conv2d,
    ConvTranspose2d, sparse-conv and BatchNorm leaves (the detectors'):
    ``{"params": ..., "batch_stats": ...}`` nested dicts of numpy arrays
    in the flax layout, under the module names. Raises KeyError for any
    other kind of tensor."""
    kinds = {name: mod for name, mod in model.named_modules()}
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        prefix, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        mod = kinds.get(prefix)
        a = t.detach().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            col, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias":
            col, name = "params", "bias"
        elif leaf == "weight" and a.ndim == 1:
            col, name = "params", "scale"
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            col, name = "params", "kernel"
            a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif isinstance(mod, torch.nn.Conv2d):
            col, name = "params", "kernel"
            a = a.transpose(2, 3, 1, 0)
        elif isinstance(mod, torch.nn.Linear):
            col, name = "params", "kernel"
            a = a.T
        elif leaf == "weight" and a.ndim == 3:          # sparse (K, Ci, Co)
            col, name = "params", "kernel"
        else:
            raise KeyError(f"no flax leaf for {key} {tuple(a.shape)}")
        node = out[col]
        for part in prefix.split(".") if prefix else ():
            node = node.setdefault(part, {})
        node[name] = np.array(a, order="C")
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping
                       ) -> torch.nn.Module:
    """Load converted flax variables into ``model`` in place."""
    model.load_state_dict(convert_variables(variables, model), strict=True)
    return model


def convert_optimizer_state(model: torch.nn.Module, mu: Mapping, nu: Mapping,
                            gradient_step: int,
                            acc_grads: Optional[Mapping] = None,
                            mini_step: int = 0) -> Dict[str, object]:
    """``AccumulatingAdam.load_state_dict`` input from the optimizer leaves
    of the JAX train state, as numpy trees shaped like ``params``.

    ``mu`` / ``nu``: optax ``ScaleByAdamState``'s moments; ``gradient_step``:
    the applied updates (``MultiStepsState.gradient_step``, or the Adam
    ``count`` without accumulation); ``acc_grads`` / ``mini_step``:
    ``MultiStepsState``'s running mean and its micro-step count (absent at
    ``grad_accum_steps`` 1: zeros). Leaves map as the weights do; the port's
    optimizer holds the trainable parameters only, so a frozen parameter's
    leaves must be zero (JAX keeps them, with zero gradients) and are
    dropped. Raises KeyError for a trainable parameter without leaves,
    ValueError for a shape mismatch or a non-zero frozen leaf.
    """
    params = dict(model.named_parameters())
    trainable = [k for k, p in params.items() if p.requires_grad]

    def place(tree: Optional[Mapping], what: str):
        found: Dict[str, np.ndarray] = {}
        for path, leaf in _flatten(tree or {}):
            key, arr = _target("params", path, leaf)
            if key not in params:
                raise KeyError(f"{what}/{'/'.join(path)} -> {key}: no such "
                               "parameter in the port")
            if not params[key].requires_grad:
                if np.any(arr):
                    raise ValueError(f"{what}: frozen parameter {key} has a "
                                     "non-zero leaf")
                continue
            if tuple(arr.shape) != tuple(params[key].shape):
                raise ValueError(f"{what} {key}: {arr.shape} vs port "
                                 f"{tuple(params[key].shape)}")
            found[key] = arr
        if tree is None:
            return [torch.zeros_like(params[k]) for k in trainable]
        missing = [k for k in trainable if k not in found]
        if missing:
            raise KeyError(f"{what}: no leaf for {missing}")
        return [torch.from_numpy(np.ascontiguousarray(found[k])).to(
            params[k].detach()) for k in trainable]

    return {"exp_avg": place(mu, "mu"), "exp_avg_sq": place(nu, "nu"),
            "acc": place(acc_grads, "acc_grads"),
            "mini_step": int(mini_step), "updates": int(gradient_step)}
