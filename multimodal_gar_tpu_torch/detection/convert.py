"""pcdet-checkpoint conversion: torch SECOND weights -> the zoo's
flax-layout tree -> the port's modules (detection/convert.py).

The numpy part is the JAX package's converter: sparse-conv kernels of any
spconv layout -- 1.x (kz, ky, kx, c_out, c_in), 2.x (kz, ky, kx, c_in,
c_out), implicit gemm (c_out, kz, ky, kx, c_in) -- become (K^3, c_in,
c_out) in (dz, dy, dx) scan order; 2D convs become HWIO; the first BEV
conv's input channels move from pcdet's c-major HeightCompression order to
the zoo's d-major one; SECOND_NAME_MAP maps the SECOND / VoxelRCNN trunk's
names. ``load_pcdet_second`` carries the result into a port detector
through the port's own converter (convert.py).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def _numpy_copy(tree):
    """A deep copy of a nested dict with numpy leaves."""
    if isinstance(tree, dict):
        return {k: _numpy_copy(v) for k, v in tree.items()}
    return np.array(tree)


def normalize_spconv_kernel(val: np.ndarray, c_in: int, c_out: int
                            ) -> np.ndarray:
    """Any spconv kernel layout -> (K^3, c_in, c_out)."""
    if val.ndim != 5:
        raise ValueError(f"expected a 5D sparse kernel, got {val.shape}")
    if val.shape[-2:] == (c_in, c_out):          # spconv 2.x
        k = val
    elif val.shape[-2:] == (c_out, c_in):        # spconv 1.x
        k = np.swapaxes(val, -1, -2)
    elif val.shape[0] == c_out and val.shape[-1] == c_in:   # implicit gemm
        k = np.moveaxis(val, 0, -1)              # (kz,ky,kx,c_in,c_out)
    else:
        raise ValueError(f"cannot match kernel {val.shape} to "
                         f"(cin={c_in}, cout={c_out})")
    kz, ky, kx = k.shape[:3]
    return np.ascontiguousarray(k.reshape(kz * ky * kx, c_in, c_out))


def torch_conv2d_to_nhwc(val: np.ndarray) -> np.ndarray:
    """torch Conv2d (c_out, c_in, kh, kw) -> flax (kh, kw, c_in, c_out)."""
    return np.transpose(val, (2, 3, 1, 0))


def bev_input_channel_perm(d: int, c: int) -> np.ndarray:
    """Permutation mapping pcdet's c-major Z-folded BEV channels to ours.

    HeightCompression views dense (N, C, D, H, W) as (N, C*D, H, W) — channel
    index c*D+d — while sparse_to_dense_bev stacks d-major (d*C+c, bev.py:33).
    Returns perm with new_in[d*C+c] = old_in[perm[d*C+c]] = old_in[c*D+d].
    """
    return (np.arange(c)[None, :] * d + np.arange(d)[:, None]).reshape(-1)


# torch module path prefix -> (flax params path, kind)
# kinds: sparse | conv2d | deconv2d | bn
SECOND_NAME_MAP = {
    "backbone_3d.conv_input.0": ("trunk/backbone_3d/conv_input/conv", "sparse"),
    "backbone_3d.conv_input.1": ("trunk/backbone_3d/conv_input/bn", "bn"),
    "backbone_3d.conv1.0.0": ("trunk/backbone_3d/conv1_0/conv", "sparse"),
    "backbone_3d.conv1.0.1": ("trunk/backbone_3d/conv1_0/bn", "bn"),
    "backbone_3d.conv2.0.0": ("trunk/backbone_3d/conv2_down/conv", "sparse"),
    "backbone_3d.conv2.0.1": ("trunk/backbone_3d/conv2_down/bn", "bn"),
    "backbone_3d.conv2.1.0": ("trunk/backbone_3d/conv2_1/conv", "sparse"),
    "backbone_3d.conv2.1.1": ("trunk/backbone_3d/conv2_1/bn", "bn"),
    "backbone_3d.conv2.2.0": ("trunk/backbone_3d/conv2_2/conv", "sparse"),
    "backbone_3d.conv2.2.1": ("trunk/backbone_3d/conv2_2/bn", "bn"),
    "backbone_3d.conv3.0.0": ("trunk/backbone_3d/conv3_down/conv", "sparse"),
    "backbone_3d.conv3.0.1": ("trunk/backbone_3d/conv3_down/bn", "bn"),
    "backbone_3d.conv3.1.0": ("trunk/backbone_3d/conv3_1/conv", "sparse"),
    "backbone_3d.conv3.1.1": ("trunk/backbone_3d/conv3_1/bn", "bn"),
    "backbone_3d.conv3.2.0": ("trunk/backbone_3d/conv3_2/conv", "sparse"),
    "backbone_3d.conv3.2.1": ("trunk/backbone_3d/conv3_2/bn", "bn"),
    "backbone_3d.conv4.0.0": ("trunk/backbone_3d/conv4_down/conv", "sparse"),
    "backbone_3d.conv4.0.1": ("trunk/backbone_3d/conv4_down/bn", "bn"),
    "backbone_3d.conv4.1.0": ("trunk/backbone_3d/conv4_1/conv", "sparse"),
    "backbone_3d.conv4.1.1": ("trunk/backbone_3d/conv4_1/bn", "bn"),
    "backbone_3d.conv4.2.0": ("trunk/backbone_3d/conv4_2/conv", "sparse"),
    "backbone_3d.conv4.2.1": ("trunk/backbone_3d/conv4_2/bn", "bn"),
    "backbone_3d.conv_out.0": ("trunk/conv_out/conv", "sparse"),
    "backbone_3d.conv_out.1": ("trunk/conv_out/bn", "bn"),
    "dense_head.conv_cls": ("dense_head/conv_cls", "conv2d"),
    "dense_head.conv_box": ("dense_head/conv_box", "conv2d"),
    "dense_head.conv_dir_cls": ("dense_head/conv_dir_cls", "conv2d"),
}


def _bev_block_map(layer_nums=(5, 5)) -> Dict[str, Tuple[str, str]]:
    """backbone_2d.blocks/deblocks indices -> our named modules
    (bev.py BaseBEVBackbone naming)."""
    out = {}
    for b, n in enumerate(layer_nums):
        # torch Sequential: [ZeroPad, Conv, BN, ReLU, (Conv, BN, ReLU) * n]
        out[f"backbone_2d.blocks.{b}.1"] = (
            f"trunk/backbone_2d/block{b}_down_conv", "conv2d")
        out[f"backbone_2d.blocks.{b}.2"] = (
            f"trunk/backbone_2d/block{b}_down_bn", "bn")
        for k in range(n):
            out[f"backbone_2d.blocks.{b}.{3 * k + 4}"] = (
                f"trunk/backbone_2d/block{b}_l{k}_conv", "conv2d")
            out[f"backbone_2d.blocks.{b}.{3 * k + 5}"] = (
                f"trunk/backbone_2d/block{b}_l{k}_bn", "bn")
        out[f"backbone_2d.deblocks.{b}.0"] = (
            f"trunk/backbone_2d/deblock{b}_deconv", "deconv2d")
        out[f"backbone_2d.deblocks.{b}.1"] = (
            f"trunk/backbone_2d/deblock{b}_bn", "bn")
    return out


def _set_path(tree: Dict[str, Any], path: str, leaf: str, val: np.ndarray,
              strict: bool):
    node = tree
    for p in path.split("/"):
        if p not in node:
            if strict:
                raise KeyError(f"missing module {path} (at {p})")
            return False
        node = node[p]
    if leaf not in node:
        if strict:
            raise KeyError(f"missing leaf {path}/{leaf}")
        return False
    if tuple(node[leaf].shape) != tuple(val.shape):
        raise ValueError(
            f"shape mismatch at {path}/{leaf}: {node[leaf].shape} vs "
            f"{val.shape}")
    node[leaf] = val.astype(np.asarray(node[leaf]).dtype)
    return True


# leaves/keys the converter deliberately ignores: torch BN bookkeeping
# buffers and pcdet checkpoint bookkeeping entries
IGNORED_LEAVES = ("num_batches_tracked",)
IGNORED_KEYS = ("global_step",)


def unconsumed_pcdet_keys(state_dict, layer_nums=(5, 5)) -> list:
    """Checkpoint keys convert_pcdet_second neither maps nor deliberately
    ignores — the key-manifest guard (tests/test_converter_manifests.py):
    a published pcdet SECOND checkpoint must come back empty, so any key
    this converter would silently skip is surfaced.
    """
    name_map = dict(SECOND_NAME_MAP)
    name_map.update(_bev_block_map(layer_nums))
    out = []
    for key in state_dict:
        if key in IGNORED_KEYS:
            continue
        base, leaf = key.rsplit(".", 1)
        if leaf in IGNORED_LEAVES:
            continue
        if base in name_map:
            continue
        out.append(key)
    return out


def convert_pcdet_second(state_dict: Dict[str, np.ndarray],
                         variables: Dict[str, Any],
                         layer_nums=(5, 5), strict: bool = True
                         ) -> Tuple[Dict[str, Any], int]:
    """Overlay a pcdet SECOND torch state dict onto init'd Flax variables.

    Returns (new variables, number of tensors loaded). BN running stats land
    in 'batch_stats'; kernels/scales/biases in 'params'.
    """
    name_map = dict(SECOND_NAME_MAP)
    name_map.update(_bev_block_map(layer_nums))
    params = _numpy_copy(variables["params"])
    stats = _numpy_copy(variables.get("batch_stats", {}))

    loaded = 0
    for torch_key, val in state_dict.items():
        base, leaf = torch_key.rsplit(".", 1)
        if base not in name_map:
            continue
        path, kind = name_map[base]
        val = np.asarray(val)
        if kind == "sparse" and leaf == "weight":
            # find target to infer (c_in, c_out)
            node = params
            for p in path.split("/"):
                node = node[p]
            k3, c_in, c_out = node["kernel"].shape
            ok = _set_path(params, path, "kernel",
                           normalize_spconv_kernel(val, c_in, c_out), strict)
        elif kind == "conv2d" and leaf == "weight":
            if base == "backbone_2d.blocks.0.1":
                # first BEV conv consumes the Z-folded sparse_to_dense_bev
                # map, which is d-major here vs pcdet's c-major
                # HeightCompression view — permute the in-channel axis
                # (ADVICE r2 high finding).
                try:
                    node = params
                    for p in "trunk/conv_out/conv".split("/"):
                        node = node[p]
                    c_bev = node["kernel"].shape[-1]
                except KeyError:
                    c_bev = None
                if c_bev is not None and val.shape[1] % c_bev == 0 \
                        and val.shape[1] != c_bev:
                    d_bev = val.shape[1] // c_bev
                    val = val[:, bev_input_channel_perm(d_bev, c_bev)]
            ok = _set_path(params, path, "kernel",
                           torch_conv2d_to_nhwc(val), strict)
        elif kind == "deconv2d" and leaf == "weight":
            # torch ConvTranspose2d: (c_in, c_out, kh, kw) -> flax
            # ConvTranspose (kh, kw, c_in, c_out)
            ok = _set_path(params, path, "kernel",
                           np.transpose(val, (2, 3, 0, 1)), strict)
        elif kind in ("conv2d", "deconv2d") and leaf == "bias":
            ok = _set_path(params, path, "bias", val, strict)
        elif kind == "bn":
            if leaf == "weight":
                ok = _set_path(params, path, "scale", val, strict)
            elif leaf == "bias":
                ok = _set_path(params, path, "bias", val, strict)
            elif leaf == "running_mean":
                ok = _set_path(stats, path, "mean", val, strict)
            elif leaf == "running_var":
                ok = _set_path(stats, path, "var", val, strict)
            else:                                 # num_batches_tracked
                continue
        else:
            continue
        loaded += int(bool(ok))
    out = dict(variables)
    out["params"] = params
    out["batch_stats"] = stats
    return out, loaded


def load_pcdet_second(model, state_dict: Dict[str, np.ndarray],
                      layer_nums=(5, 5), strict: bool = True) -> int:
    """Load a pcdet SECOND (or VoxelRCNN trunk) state dict into a port
    detector in place: the model's weights in the flax layout
    (convert.py: export_variables), the pcdet tensors laid over them by
    ``convert_pcdet_second``, and the result loaded back. Returns the
    number of tensors loaded."""
    from ..convert import export_variables, load_jax_variables
    variables, loaded = convert_pcdet_second(
        {k: np.asarray(v) for k, v in state_dict.items()},
        export_variables(model), layer_nums, strict)
    load_jax_variables(model, variables)
    return loaded
