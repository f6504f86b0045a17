"""Operations and least bytes of an MGAR request or micro-step, worked out
from the configuration's widths and the clip's own voxels, whatever
implements them.

- The I3D (Inception-v1 inflated, Carreira and Zisserman 2017) up to
  Mixed_4f: every conv as 2 x Cin x Cout x taps x output sites, over the
  temporal backward cone of Mixed_4f's centre slice that the frozen
  branch needs (its 1x1 convs before a 3x3x3 one over the cone's input
  extent). Pools, BatchNorm and ReLU count no operations.
- The stem (Conv3d_1a_7x7) alone: its operations, and its least bytes:
  the frames read once, the 7x7x7x3x64 kernel, its bias and scale, the
  output written once.
- VoxelBackbone8x's 11 sparse convs: 2 x C x D per present tap, the taps
  counted on the benchmark's own copy of the map rule
  (reference/frozen/ops/device_rulebook.py) over the clip's voxels; least
  bytes: the valid input rows, the weights, the output rows and the map
  (9 packed words a row for the x-window forward, 27 for the index maps
  of the gradients). A micro-step adds each layer's data gradient (not
  conv_input's: the voxel features need none) and weight gradient at the
  same operations.

The rest of a request (RoIAlign, the grid pool, attention, embeddings,
fusion and heads) is left out: under 2% of the I3D's operations at mil3's
sizes, so ``mfu`` is a slight underestimate and never an overestimate.
"""
from __future__ import annotations

from typing import Dict, List

import torch

# (name, (b0, b1a, b1b, b2a, b2b, b3b)) widths of I3D's Mixed modules
INCEPTION = (("Mixed_3b", (64, 96, 128, 16, 32, 32)),
             ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
             ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
             ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
             ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
             ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
             ("Mixed_4f", (256, 160, 320, 32, 128, 128)))

# VoxelBackbone8x: (layer, map, stage of the output rows, stage of the
# input rows, C, D); C of conv_input is the point features' width
SPARSE_LAYERS = (("conv_input", "nbr_0", 0, 0, None, 16),
                 ("conv1_0", "nbr_0", 0, 0, 16, 16),
                 ("conv2_down", "down_1", 1, 0, 16, 32),
                 ("conv2_1", "nbr_1", 1, 1, 32, 32),
                 ("conv2_2", "nbr_1", 1, 1, 32, 32),
                 ("conv3_down", "down_2", 2, 1, 32, 64),
                 ("conv3_1", "nbr_2", 2, 2, 64, 64),
                 ("conv3_2", "nbr_2", 2, 2, 64, 64),
                 ("conv4_down", "down_3", 3, 2, 64, 64),
                 ("conv4_1", "nbr_3", 3, 3, 64, 64),
                 ("conv4_2", "nbr_3", 3, 3, 64, 64))

F32 = 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def stem_counts(t: int, h: int, w: int) -> Dict[str, float]:
    """The stem's operations and least bytes for one (t, h, w) clip."""
    to, ho, wo = _ceil(t, 2), _ceil(h, 2), _ceil(w, 2)
    flop = 2.0 * 3 * 64 * 343 * to * ho * wo
    nbytes = F32 * (t * h * w * 3 + 343 * 3 * 64 + 2 * 64 + to * ho * wo * 64)
    return {"flop": flop, "bytes": float(nbytes)}


def _mixed(cin: int, oc, t_in: int, t_out: int, hw: int) -> float:
    b0, b1a, b1b, b2a, b2b, b3b = oc
    return 2.0 * hw * (cin * b0 * t_out + cin * b1a * t_in
                       + 27 * b1a * b1b * t_out + cin * b2a * t_in
                       + 27 * b2a * b2b * t_out + cin * b3b * t_out)


def i3d_flop(t: int, h: int, w: int) -> float:
    """Operations of the I3D up to Mixed_4f's centre slice (the cone)."""
    t1, h1, w1 = _ceil(t, 2), _ceil(h, 2), _ceil(w, 2)
    flop = stem_counts(t, h, w)["flop"]
    h2, w2 = _ceil(h1, 2), _ceil(w1, 2)                 # MaxPool3d_2a
    flop += 2.0 * 64 * 64 * t1 * h2 * w2                # Conv3d_2b_1x1
    flop += 2.0 * 27 * 64 * 192 * t1 * h2 * w2          # Conv3d_2c_3x3
    h3, w3 = _ceil(h2, 2), _ceil(w2, 2)                 # MaxPool3d_3a
    t4, h4, w4 = _ceil(t1, 2), _ceil(h3, 2), _ceil(w3, 2)   # MaxPool3d_4a
    # the cone: the slices each Mixed_4x module reads and writes
    lo, hi = t4 // 2, t4 // 2 + 1
    extent = {}
    for name in ("Mixed_4f", "Mixed_4e", "Mixed_4d", "Mixed_4c",
                 "Mixed_4b"):
        out = hi - lo
        lo, hi = max(lo - 1, 0), min(hi + 1, t4)
        extent[name] = (hi - lo, out)
    cin = 192
    for name, oc in INCEPTION:
        if name.startswith("Mixed_3"):
            flop += _mixed(cin, oc, t1, t1, h3 * w3)
        else:
            t_in, t_out = extent[name]
            flop += _mixed(cin, oc, t_in, t_out, h4 * w4)
        cin = oc[0] + oc[2] + oc[4] + oc[5]
    return flop


def sparse_layers(coords: torch.Tensor, valid: torch.Tensor, spatial_shape,
                  caps, point_features: int, device) -> List[dict]:
    """Each sparse layer's present taps and row counts for one sample:
    ``coords`` (1, M, 3) zyx, ``valid`` (1, M), over a (z, y, x)
    ``spatial_shape`` at the stage ``caps``."""
    from reference.frozen.ops.device_rulebook import device_rulebook
    caps = tuple(caps)
    coords = coords.to(device)
    valid = valid.to(device)
    rb = device_rulebook(coords, valid, tuple(spatial_shape), caps)
    rows = {0: int(valid.sum())}
    for k in range(1, len(caps)):
        rows[k] = int(rb[f"count_{k}"].sum())
    out = []
    for name, key, s_out, s_in, c, d in SPARSE_LAYERS:
        c = c or point_features
        m = rb[key][0]
        live = valid[0] if s_out == 0 else (
            torch.arange(m.shape[0], device=device) < rows[s_out])
        taps = int(((m >= 0) & live[:, None]).sum())
        out.append({"layer": name, "taps": taps, "rows_out": rows[s_out],
                    "rows_in": rows[s_in], "c": c, "d": d})
    return out


def sparse_counts(layers: List[dict], train: bool,
                  fwd_map_words: int = 9) -> Dict[str, float]:
    """The sparse layers' operations and least bytes, forward (its map
    ``fwd_map_words`` int32 a row: 9 for the packed x-window map, 27 for an
    index map) and, in training, the data and weight gradients."""
    fwd_flop = fwd_bytes = dg_flop = dg_bytes = wg_flop = wg_bytes = 0.0
    for L in layers:
        op = 2.0 * L["taps"] * L["c"] * L["d"]
        w = 27 * L["c"] * L["d"]
        fwd_flop += op
        fwd_bytes += F32 * (L["rows_in"] * L["c"] + w + L["rows_out"] * L["d"]
                            + L["rows_out"] * fwd_map_words)
        if train:
            if L["layer"] != "conv_input":
                dg_flop += op
                dg_bytes += F32 * (L["rows_out"] * L["d"] + w
                                   + L["rows_in"] * L["c"]
                                   + L["rows_in"] * 27)
            wg_flop += op
            wg_bytes += F32 * (L["rows_in"] * L["c"] + L["rows_out"] * L["d"]
                               + w + L["rows_out"] * 27)
    return {"sparse_fwd_flop": fwd_flop, "sparse_fwd_bytes": fwd_bytes,
            "sparse_dgrad_flop": dg_flop, "sparse_dgrad_bytes": dg_bytes,
            "sparse_wgrad_flop": wg_flop, "sparse_wgrad_bytes": wg_bytes}


def request_counts(cfgj: dict, cfg, batch, loop: str, device) -> dict:
    """Counts of one request (``loop`` eval) or micro-step (train) on the
    clip in ``batch`` (a host Batch of batch size 1)."""
    d = cfg.data
    t, (h, w) = d.num_frames, d.image_size
    stem = stem_counts(t, h, w)
    pc = cfg.data.point_cloud
    nx, ny, nz = pc.grid_size
    sparse = sparse_counts(sparse_layers(
        batch.voxel_coords, batch.voxel_valid, (nz + 1, ny, nx),
        cfg.model.lidar.max_voxels_per_stage, pc.num_point_features,
        device), loop == "train")
    flop = i3d_flop(t, h, w) + sparse["sparse_fwd_flop"] \
        + sparse["sparse_dgrad_flop"] + sparse["sparse_wgrad_flop"]
    return {"flop": flop, "stem_flop": stem["flop"],
            "stem_bytes": stem["bytes"], **sparse}


def total(per_clip: List[dict], served: List[int]) -> Dict[str, float]:
    """Sums of the counts over the served clips (indices into the pool)."""
    out: Dict[str, float] = {}
    for i in served:
        for k, v in per_clip[i].items():
            out[k] = out.get(k, 0.0) + v
    return out
