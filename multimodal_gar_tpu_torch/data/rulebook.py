"""Host-side sparse-convolution rulebook construction.

The sparse backbone's index structures — submanifold neighbor maps, strided
downsample active sets, and downsample gather maps — are pure functions of the
voxel coordinates, which the host voxelizer already produced. They are built
here (numpy / C++ in the data pipeline, overlapped with device compute) and
not in the device step. This mirrors what spconv's rulebook code does for
the reference, relocated to the input pipeline. The port's copy of
multimodal_gar_tpu/data/rulebook.py; it computes the same maps.

Layout per stage k (see models/sparse_backbone.py for consumption):
  coords_k   (M_k, 3) int32 zyx        voxel coords of the stage's active set
  valid_k    (M_k,)  bool
  nbr_k      (M_k, 27) int32           submanifold 3^3 neighbor rows (-1 absent)
  down_k     (M_k, 27) int32           rows into stage k-1 feeding each output
                                       (strided 3^3 taps; -1 absent; k >= 1)

x-window maps (``x_window=True``; see ops/kernels/window_conv.py): the device
gathers 9 rows/query of a 3C-wide shifted table instead of 27 rows of width
C. Voxels within a stage are ordered by linear key (padded
rows last); for each query and each (dz, dy) tap pair one packed int32
carries the window position j = searchsorted(keys, center-tap key) in its
low 20 bits and, in bits 20..25, the window slot (0..2, 3 = absent) holding
each of the dx in {-1, 0, +1} taps:
  order_0    (M_0,) int32              key-sorted order of the stage-0 rows
  win_k      (M_k, 9) int32            submanifold window map (k = 0..3)
  dwin_k     (M_k, 9) int32            strided-conv window map into stage
                                       k-1's sorted rows (k >= 1)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# stage schedule of VoxelBackBone8x (reference spconv_backbone.py:84-117)
STAGE_STRIDES = (1, 2, 2, 2)                 # stage k downsamples by this
STAGE_PADDINGS = ((1, 1, 1), (1, 1, 1), (1, 1, 1), (0, 1, 1))
KERNEL_SIZE = 3


def _linear_keys(coords: np.ndarray, shape: Tuple[int, int, int]) -> np.ndarray:
    z, y, x = coords[:, 0], coords[:, 1], coords[:, 2]
    return (z.astype(np.int64) * shape[1] + y) * shape[2] + x


def _lookup(sorted_keys: np.ndarray, perm: np.ndarray,
            query_keys: np.ndarray, query_ok: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(sorted_keys, query_keys)
    pos = np.clip(pos, 0, max(len(sorted_keys) - 1, 0))
    hit = query_ok & (len(sorted_keys) > 0)
    if len(sorted_keys):
        hit = hit & (sorted_keys[pos] == query_keys)
    return np.where(hit, perm[np.clip(pos, 0, None)], -1).astype(np.int32)


def _kernel_offsets_centered() -> np.ndarray:
    g = np.arange(-1, 2)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([zz.ravel(), yy.ravel(), xx.ravel()], -1)     # (27, 3)


def _kernel_offsets_corner() -> np.ndarray:
    g = np.arange(KERNEL_SIZE)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([zz.ravel(), yy.ravel(), xx.ravel()], -1)     # (27, 3)


def _subm_neighbors(coords: np.ndarray, n_valid: int,
                    shape: Tuple[int, int, int], max_rows: int) -> np.ndarray:
    """(max_rows, 27) neighbor rows for the submanifold 3^3 conv."""
    out = np.full((max_rows, 27), -1, np.int32)
    if n_valid == 0:
        return out
    c = coords[:n_valid]
    keys = _linear_keys(c, shape)
    perm = np.argsort(keys, kind="stable")
    skeys = keys[perm]
    offs = _kernel_offsets_centered()
    nbr = c[:, None, :] + offs[None, :, :]                        # (M, 27, 3)
    ok = np.all((nbr >= 0) & (nbr < np.asarray(shape)), axis=-1)
    qkeys = _linear_keys(nbr.reshape(-1, 3), shape)
    out[:n_valid] = _lookup(skeys, perm.astype(np.int32), qkeys,
                            ok.reshape(-1)).reshape(n_valid, 27)
    return out


def _downsample(coords: np.ndarray, n_valid: int,
                in_shape: Tuple[int, int, int], stride: int,
                padding: Tuple[int, int, int], max_out: int):
    """Derive the strided-conv output active set + gather map.

    spconv.SparseConv3d semantics (kernel 3): output o is active iff some
    input i = o*stride - pad + k is active. Output voxels ordered by linear
    key (deterministic).
    """
    out_shape = tuple((d + 2 * p - KERNEL_SIZE) // stride + 1
                      for d, p in zip(in_shape, padding))
    out_coords = np.full((max_out, 3), -1, np.int32)
    down = np.full((max_out, 27), -1, np.int32)
    if n_valid == 0:
        return out_coords, 0, down, out_shape

    c = coords[:n_valid]
    p = np.asarray(padding)
    koffs = _kernel_offsets_corner()                              # (27, 3)
    num = c[:, None, :] + p[None, None, :] - koffs[None, :, :]    # (M, 27, 3)
    o = num // stride
    exact = np.all(o * stride == num, axis=-1)
    in_range = np.all((o >= 0) & (o < np.asarray(out_shape)), axis=-1)
    ok = exact & in_range
    cand = o[ok]
    keys = np.unique(_linear_keys(cand, out_shape))
    n_out = min(len(keys), max_out)
    keys = keys[:n_out]
    oz = keys // (out_shape[1] * out_shape[2])
    oy = (keys // out_shape[2]) % out_shape[1]
    ox = keys % out_shape[2]
    out_coords[:n_out] = np.stack([oz, oy, ox], -1)

    # gather map: input row feeding output o at tap k: i = o*stride - pad + k
    in_keys = _linear_keys(c, in_shape)
    perm = np.argsort(in_keys, kind="stable")
    skeys = in_keys[perm]
    src = (out_coords[:n_out, None, :] * stride - p[None, None, :]
           + koffs[None, :, :])                                   # (Mo, 27, 3)
    ok_src = np.all((src >= 0) & (src < np.asarray(in_shape)), axis=-1)
    qkeys = _linear_keys(src.reshape(-1, 3), in_shape)
    down[:n_out] = _lookup(skeys, perm.astype(np.int32), qkeys,
                           ok_src.reshape(-1)).reshape(n_out, 27)
    return out_coords, n_out, down, out_shape


WINDOW_POS_BITS = 20
WINDOW_POS_MASK = (1 << WINDOW_POS_BITS) - 1


def _pair_offsets_zy(offsets: np.ndarray) -> np.ndarray:
    """(9, 2) unique (dz, dy) of a 27-tap offset set in scan order."""
    return offsets.reshape(9, 3, 3)[:, 0, :2]


def _window_map(src_center: np.ndarray, n_valid_q: int,
                in_skeys: np.ndarray, n_valid_in: int,
                in_shape: Tuple[int, int, int]) -> np.ndarray:
    """Packed x-window map: position (low 20 bits) + dx slot selectors.

    Args:
      src_center: (R, 9, 3) int64 zyx coords of each query's center (dx=0)
        tap per (dz, dy) pair; rows >= n_valid_q are ignored.
      in_skeys: (M,) int64 keys of the input stage, sorted, valid first.
    Returns:
      (R, 9) int32: j | sel << 20 with sel = slot(dx=-1) | slot(0) << 2
      | slot(+1) << 4, slot in {0, 1, 2} window rows (j-1, j, j+1) or 3.
    """
    r = src_center.shape[0]
    m = len(in_skeys)
    shape = np.asarray(in_shape, np.int64)
    out = np.full((r, 9), 3 | (3 << 2) | (3 << 4), np.int64) << WINDOW_POS_BITS
    if n_valid_q == 0 or n_valid_in == 0:
        return out.astype(np.int32)

    sc = src_center[:n_valid_q].astype(np.int64)                 # (R', 9, 3)
    zy_ok = ((sc[..., 0] >= 0) & (sc[..., 0] < shape[0])
             & (sc[..., 1] >= 0) & (sc[..., 1] < shape[1]))      # (R', 9)
    ckey = (sc[..., 0] * shape[1] + sc[..., 1]) * shape[2] + sc[..., 2]
    skeys = in_skeys[:n_valid_in]
    j = np.searchsorted(skeys, ckey)                             # (R', 9)
    pos = np.clip(j, 0, n_valid_in - 1)
    # keys at the clipped window rows pos-1, pos, pos+1 (sentinel-guarded)
    pad = np.concatenate([[-1], skeys, [np.iinfo(np.int64).max]])
    wkeys = np.stack([pad[pos], pad[pos + 1], pad[pos + 2]], -1)  # (R',9,3)

    sel = np.zeros(zy_ok.shape, np.int64)
    for dxi, dx in enumerate((-1, 0, 1)):
        x = sc[..., 2] + dx
        ok = zy_ok & (x >= 0) & (x < shape[2])
        t = ckey + dx
        match = (wkeys == t[..., None]) & ok[..., None]           # (R',9,3)
        slot = np.where(match.any(-1), match.argmax(-1), 3)
        sel |= slot << (2 * dxi)
    out[:n_valid_q] = pos | (sel << WINDOW_POS_BITS)
    return out.astype(np.int32)


def _band_spread_max(win: np.ndarray, qb: int = 128) -> int:
    """Max row spread of any (qb-query block, window slot) pair's present
    taps, with the block start 8-aligned — the exactness contract of the
    fused band kernel (ops/pallas/window_conv.window_conv_band): it gathers
    each block's taps from one contiguous band of the key-sorted table, so
    the spread must stay < its band width (default 640)."""
    m = win.shape[0]
    mp = -(-m // qb) * qb
    absent = (3 | 3 << 2 | 3 << 4) << WINDOW_POS_BITS
    w = np.pad(win, ((0, mp - m), (0, 0)), constant_values=absent)
    pos = (w & WINDOW_POS_MASK).astype(np.int64)
    sel = w >> WINDOW_POS_BITS
    present = ((sel & 3) != 3) | (((sel >> 2) & 3) != 3) \
        | (((sel >> 4) & 3) != 3)
    pb = pos.reshape(-1, qb, 9)
    prb = present.reshape(-1, qb, 9)
    mn = (np.min(np.where(prb, pb, 2 ** 30), axis=1) // 8) * 8
    mx = np.max(np.where(prb, pb, -1), axis=1)
    sp = mx - mn
    return int(sp[mx >= 0].max(initial=0))


def _stamp_band_ok(rb: Dict[str, np.ndarray], band: int = 640) -> None:
    """rb['band_ok'] = 1 iff every fused-eligible stage map (win_1..win_3,
    the cin>=32 submanifold layers) satisfies the band kernel's spread
    contract. Stored per item so pipelines/tests can verify before enabling
    LiDARBackboneConfig.x_window_fused; the kernel itself zeroes (not
    corrupts) out-of-band taps."""
    ok = all(_band_spread_max(rb[f"win_{k}"]) < band
             for k in (1, 2, 3) if f"win_{k}" in rb)
    rb["band_ok"] = np.int32(ok)


def add_x_window_maps(rb: Dict[str, np.ndarray], coords0: np.ndarray,
                      n_valid0: int, spatial_shape: Tuple[int, int, int],
                      max_voxels_per_stage: Sequence[int]
                      ) -> Dict[str, np.ndarray]:
    """Append order_0 / win_k / dwin_k to a built rulebook (numpy or C++).

    Stage-0 rows are re-ordered by linear key (order_0, applied by the
    backbone before the first conv); downsampled stages are already
    key-sorted by construction (np.unique / std::sort in the two versions).
    """
    # the packed window word stores the row index in WINDOW_POS_BITS bits;
    # a stage cap beyond that would silently corrupt the slot-selector bits
    assert max(max_voxels_per_stage) <= WINDOW_POS_MASK, (
        f"x-window maps pack row indices into {WINDOW_POS_BITS} bits; "
        f"stage caps {tuple(max_voxels_per_stage)} exceed {WINDOW_POS_MASK}")
    try:
        from ..native import native_xwindow
        if native_xwindow(rb, coords0, n_valid0, spatial_shape,
                          max_voxels_per_stage):
            _stamp_band_ok(rb)
            return rb
    except ImportError:
        pass
    cap0 = max_voxels_per_stage[0]
    n_valid0 = min(n_valid0, cap0, len(coords0))
    c0 = np.full((cap0, 3), -(10 ** 6), np.int64)
    c0[:n_valid0] = coords0[:n_valid0].astype(np.int64)
    keys0 = _linear_keys_checked(c0, spatial_shape)
    order = np.argsort(keys0, kind="stable").astype(np.int32)
    rb["order_0"] = order

    pair_c = _pair_offsets_zy(_kernel_offsets_centered()).astype(np.int64)
    cur_coords = c0[order]
    cur_keys = keys0[order]
    cur_valid = n_valid0
    cur_shape = spatial_shape
    for k in range(4):
        if k > 0:
            stride = STAGE_STRIDES[k]
            pad = np.asarray(STAGE_PADDINGS[k], np.int64)
            out_shape = tuple(
                (d + 2 * p - KERNEL_SIZE) // stride + 1
                for d, p in zip(cur_shape, STAGE_PADDINGS[k]))
            oc = rb[f"coords_{k}"].astype(np.int64)
            n_out = int(rb[f"count_{k}"])
            # center tap of each (kz, ky) pair: kx = 1
            pair_d = np.stack(np.meshgrid(np.arange(3), np.arange(3),
                                          indexing="ij"), -1).reshape(9, 2)
            src = np.empty((oc.shape[0], 9, 3), np.int64)
            src[:, :, :2] = (oc[:, None, :2] * stride - pad[None, None, :2]
                             + pair_d[None, :, :])
            src[:, :, 2] = oc[:, None, 2] * stride - pad[2] + 1
            rb[f"dwin_{k}"] = _window_map(src, n_out, cur_keys, cur_valid,
                                          cur_shape)
            new_keys = _linear_keys_checked(
                np.where(np.arange(oc.shape[0])[:, None] < n_out, oc,
                         -(10 ** 6)), out_shape)
            cur_coords, cur_keys = oc, new_keys
            cur_valid, cur_shape = n_out, out_shape
        src = cur_coords[:, None, :].repeat(9, axis=1)
        src[:, :, :2] += pair_c[None, :, :]
        rb[f"win_{k}"] = _window_map(src, cur_valid, cur_keys, cur_valid,
                                     cur_shape)
    _stamp_band_ok(rb)
    return rb


def _linear_keys_checked(coords: np.ndarray,
                         shape: Tuple[int, int, int]) -> np.ndarray:
    """int64 keys; out-of-range coords -> int64 max (sorts last)."""
    s = np.asarray(shape, np.int64)
    ok = np.all((coords >= 0) & (coords < s), axis=-1)
    key = (coords[:, 0] * s[1] + coords[:, 1]) * s[2] + coords[:, 2]
    return np.where(ok, key, np.iinfo(np.int64).max)


def build_rulebook(coords: np.ndarray, n_valid: int,
                   spatial_shape: Tuple[int, int, int],
                   max_voxels_per_stage: Sequence[int],
                   x_window: bool = True) -> Dict[str, np.ndarray]:
    """Full 4-stage rulebook for VoxelBackbone8x from stage-0 voxel coords.

    Args:
      coords: (M0, 3) int32 zyx (padded rows arbitrary).
      n_valid: number of real voxels.
      spatial_shape: stage-0 (Z, Y, X).
      max_voxels_per_stage: static caps (M0..M3).
      x_window: also emit the packed x-window maps (order_0/win_k/dwin_k).
    Returns:
      flat dict of numpy arrays: coords_k, count_k, nbr_k, down_k (k=1..3),
      plus the x-window maps when requested.
    """
    try:
        from ..native import native_rulebook
        res = native_rulebook(coords, n_valid, spatial_shape,
                              tuple(max_voxels_per_stage))
        if res is not None:
            if x_window:
                res = add_x_window_maps(res, coords, n_valid, spatial_shape,
                                        max_voxels_per_stage)
            return res
    except ImportError:
        pass

    out: Dict[str, np.ndarray] = {}
    cur_coords = coords[:max_voxels_per_stage[0]]
    cur_valid = n_valid
    cur_shape = spatial_shape
    for k in range(4):
        cap = max_voxels_per_stage[k]
        if k > 0:
            new_coords, new_valid, down, new_shape = _downsample(
                cur_coords, cur_valid, cur_shape, STAGE_STRIDES[k],
                STAGE_PADDINGS[k], cap)
            out[f"down_{k}"] = down
            cur_coords, cur_valid, cur_shape = new_coords, new_valid, new_shape
            out[f"coords_{k}"] = cur_coords
            out[f"count_{k}"] = np.int32(cur_valid)
        out[f"nbr_{k}"] = _subm_neighbors(cur_coords, cur_valid, cur_shape, cap)
    if x_window:
        out = add_x_window_maps(out, coords, n_valid, spatial_shape,
                                max_voxels_per_stage)
    return out
