"""Synthetic fixtures (utils/testing.py:19-170): the tiny and flagship configs,
a random but consistent padded batch, a seeded randomisation of every
weight and statistic, and the conditioning that gradient parity checks of
the train step need.

``synthetic_batch`` makes the same numpy draws from the same seed as the JAX
package's, and takes its rulebook from the port's data/rulebook.py, a copy
of the JAX package's that a test holds equal to it, so both packages see
identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import (Config, PointCloudConfig, PoolLayerConfig,
                      VoxelizationConfig)
from ..data.rulebook import build_rulebook
from ..data.voxelizer import Voxelizer, pad_voxels
from ..types import Batch


def tiny_config(num_people: int = 8, num_frames: int = 3,
                image_hw=(48, 64), max_voxels: int = 256) -> Config:
    """A miniature config that exercises every code path cheaply."""
    cfg = Config()
    pc = PointCloudConfig(
        num_points=256,
        range=(-8.0, -8.0, -2.0, 8.0, 8.0, 3.0),
        voxel=VoxelizationConfig(voxel_size=(0.5, 0.5, 0.625),
                                 max_voxels_train=max_voxels,
                                 max_voxels_test=max_voxels),
    )
    data = dataclasses.replace(
        cfg.data, image_size=image_hw, num_frames=num_frames,
        num_boxes=num_people, point_cloud=pc)
    lidar = dataclasses.replace(
        cfg.model.lidar,
        max_voxels_per_stage=(max_voxels, max_voxels // 2, max_voxels // 4,
                              max_voxels // 8),
        pool_layers=(
            PoolLayerConfig("x_conv2", (8, 8), (2, 2, 2), 1.0, 4),
            PoolLayerConfig("x_conv4", (8, 8), (2, 2, 2), 4.0, 4),
        ),
        grid_pool_size=2,
    )
    model = dataclasses.replace(cfg.model, lidar=lidar)
    return dataclasses.replace(cfg, data=data, model=model)


def flagship_config(dtype: str = "float32", max_voxels: int = 40000) -> Config:
    """The reference's full eval working point (mil3.yaml): 720x1280
    panorama, 15 frames, 100 actor slots, 40k voxels over a 200x200x50 m
    range."""
    cfg = Config()
    pc = PointCloudConfig(
        num_points=35000,
        range=(-100.0, -100.0, -25.0, 100.0, 100.0, 25.0),
        voxel=VoxelizationConfig((0.1, 0.1, 1.25), 5, max_voxels, max_voxels),
    )
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, image_size=(720, 1280), num_frames=15, num_boxes=100,
        point_cloud=pc))
    stage_caps = (max_voxels, max_voxels, max_voxels // 2, max_voxels // 4)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype, lidar=dataclasses.replace(
            cfg.model.lidar, max_voxels_per_stage=stage_caps)))


def with_model_of(path: str, cfg: Config) -> Config:
    """``cfg`` with the ``model.rgb`` switches and ``model.fusion`` of the
    YAML config at ``path`` (``_BASE_CONFIG_`` followed): one of
    ``configs/*.yaml`` over ``tiny_config()`` or ``flagship_config()``. The
    sizes stay ``cfg``'s: the data section, the LiDAR caps and pool layers,
    the embedding widths."""
    from ..config import load_config
    src = load_config(path).model
    rgb = dataclasses.replace(
        cfg.model.rgb, inter_person=src.rgb.inter_person,
        two_stage_att=src.rgb.two_stage_att, gat_module=src.rgb.gat_module)
    lidar = dataclasses.replace(
        cfg.model.lidar, self_att_use=src.lidar.self_att_use,
        self_att_inter_person=src.lidar.self_att_inter_person,
        two_stage_att=src.lidar.two_stage_att)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rgb=rgb, lidar=lidar, fusion=src.fusion))


def with_model(cfg: Config, *, rgb=None, lidar=None, fusion=None) -> Config:
    """``cfg`` with fields of its ``model.rgb`` / ``model.lidar`` /
    ``model.fusion`` replaced (each a dict of field -> value); a
    ``pool_method`` in ``lidar`` goes to every pool layer."""
    m = cfg.model
    lidar = dict(lidar or {})
    if "pool_method" in lidar:
        method = lidar.pop("pool_method")
        lidar["pool_layers"] = tuple(
            dataclasses.replace(lc, pool_method=method)
            for lc in m.lidar.pool_layers)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, rgb=dataclasses.replace(m.rgb, **(rgb or {})),
        lidar=dataclasses.replace(m.lidar, **lidar),
        fusion=dataclasses.replace(m.fusion, **(fusion or {}))))


# every setting of the model beyond mil3's that the port honours, as
# (name, keyword arguments of ``with_model``): the cases of the variant
# tests and of chip_smoke.py's card-vs-CPU phase
MODEL_VARIANTS = tuple(
    [(f"fusion={name}", dict(fusion=dict(fusion=name))) for name in (
        "sum", "concat", "Attention_pe", "crossAtt", "catandAtt",
        "Attention_MMCA_sty", "Attention_normal", "Attention_gaussian",
        "Attention_exp", "Attention_multi", "Attention_multi_cat")]
    + [(f"sim={name}", dict(fusion=dict(sim=name)))
       for name in ("Graph", "Graph2", "Graph3", "Graph4")]
    + [(f"social_layer={name}", dict(fusion=dict(social_layer=name)))
       for name in ("mlp", "encoder")]
    + [("euclidean=false", dict(fusion=dict(euclidean=False))),
       ("sg_feat_org, ind_action_concat=false",
        dict(fusion=dict(sg_feat_org=True, ind_action_concat=False))),
       ("modality=RGB", dict(fusion=dict(modality="RGB"))),
       ("modality=LiDAR", dict(fusion=dict(modality="LiDAR"))),
       ("rgb.two_stage_att", dict(rgb=dict(two_stage_att=True))),
       ("rgb.inter_person", dict(rgb=dict(inter_person=True))),
       ("rgb.gat_module", dict(rgb=dict(gat_module=True))),
       ("lidar.two_stage_att", dict(lidar=dict(two_stage_att=True))),
       ("lidar.self_att_inter_person",
        dict(lidar=dict(self_att_inter_person=True))),
       ("lidar.self_att_use=false", dict(lidar=dict(self_att_use=False))),
       ("lidar.pool_cull_k=0", dict(lidar=dict(pool_cull_k=0))),
       ("lidar.voxel_query_exact", dict(lidar=dict(voxel_query_exact=True))),
       ("lidar.pool_method=avg_pool",
        dict(lidar=dict(pool_method="avg_pool"))),
       ("rgb.i3d_freeze=false", dict(rgb=dict(i3d_freeze=False)))])


def synthetic_batch_numpy(cfg: Config, batch_size: int = 1, seed: int = 0,
                          n_valid: int | None = None) -> dict:
    """The fields of a random but internally consistent padded batch, as
    numpy arrays (the rulebook as a dict of arrays)."""
    rng = np.random.default_rng(seed)
    d = cfg.data
    pc = d.point_cloud
    h, w = d.image_size
    n = d.num_boxes
    t = d.num_frames
    m = pc.voxel.max_voxels_train
    p = pc.voxel.max_points_per_voxel
    nv = n_valid if n_valid is not None else max(2, n // 2)

    images = rng.normal(size=(batch_size, t, h, w, 3)).astype(np.float32)

    boxes2d = np.zeros((batch_size, n, 4), np.float32)
    xy = rng.uniform(0, [w - 20, h - 20], size=(batch_size, n, 2))
    wh = rng.uniform(5, 20, size=(batch_size, n, 2))
    boxes2d[..., :2] = xy
    boxes2d[..., 2:] = xy + wh

    boxes3d = np.zeros((batch_size, n, 7), np.float32)
    boxes3d[..., 0:2] = rng.uniform(pc.range[0] + 2, pc.range[3] - 2,
                                    size=(batch_size, n, 2))
    boxes3d[..., 2] = rng.uniform(-0.5, 0.5, size=(batch_size, n))
    boxes3d[..., 3:6] = rng.uniform(0.5, 1.5, size=(batch_size, n, 3))
    boxes3d[..., 6] = rng.uniform(-np.pi, np.pi, size=(batch_size, n))

    valid = np.zeros((batch_size, n), bool)
    valid[:, :nv] = True
    boxes2d *= valid[..., None]
    boxes3d *= valid[..., None]

    sgid = rng.integers(0, max(nv // 2, 1),
                        size=(batch_size, n)).astype(np.int32)
    sgid[~valid] = -1
    actions = (rng.uniform(size=(batch_size, n, 27)) < 0.15).astype(np.float32)
    actions *= valid[..., None]
    activity = (rng.uniform(size=(batch_size, n, 27)) < 0.15
                ).astype(np.float32)
    activity *= valid[..., None]

    # voxels: random in-range points, consistent coords
    nx, ny, nz = pc.grid_size
    mv = max(m // 2, 1)
    pts = rng.uniform(
        low=[pc.range[0], pc.range[1], pc.range[2], 0],
        high=[pc.range[3], pc.range[4], pc.range[5], 1],
        size=(batch_size, m, p, 4)).astype(np.float32)
    vs = np.asarray(pc.voxel.voxel_size)
    coords_xyz = ((pts[:, :, 0, :3] - np.asarray(pc.range[:3])) // vs
                  ).astype(np.int32)
    coords_xyz = np.clip(coords_xyz, 0, np.asarray([nx - 1, ny - 1, nz - 1]))
    coords = coords_xyz[..., ::-1].copy()          # zyx
    num_points = rng.integers(1, p + 1, size=(batch_size, m)).astype(np.int32)
    vvalid = np.zeros((batch_size, m), bool)
    vvalid[:, :mv] = True
    coords[~vvalid] = -1

    # dedupe voxel coords per item (the voxelizer guarantees uniqueness)
    for b in range(batch_size):
        keys = ((coords[b, :, 0].astype(np.int64) * ny + coords[b, :, 1])
                * nx + coords[b, :, 2])
        keys[~vvalid[b]] = -1 - np.arange((~vvalid[b]).sum())
        _, first = np.unique(keys, return_index=True)
        dup = np.ones(m, bool)
        dup[first] = False
        vvalid[b, dup & vvalid[b]] = False
        coords[b, ~vvalid[b]] = -1

    # compact valid voxels to the front (the rulebook builder expects that)
    for b in range(batch_size):
        order = np.argsort(~vvalid[b], kind="stable")
        coords[b] = coords[b][order]
        pts[b] = pts[b][order]
        num_points[b] = num_points[b][order]
        vvalid[b] = vvalid[b][order]

    spatial_shape = (nz + 1, ny, nx)
    caps = cfg.model.lidar.max_voxels_per_stage
    rbs = [build_rulebook(coords[b], int(vvalid[b].sum()), spatial_shape,
                          caps) for b in range(batch_size)]
    rulebook = {k: np.stack([rb[k] for rb in rbs]) for k in rbs[0]}

    return dict(
        images=images, boxes2d=boxes2d, boxes3d=boxes3d, person_valid=valid,
        social_group_id=sgid, actions=actions,
        social_group_activity=activity, voxels=pts, voxel_coords=coords,
        voxel_num_points=num_points, voxel_valid=vvalid,
        seq_id=np.zeros((batch_size,), np.int32),
        frame_id=np.zeros((batch_size,), np.int32), rulebook=rulebook)


def clustered_points(cfg: Config, seed: int = 0,
                     blob=(10, 10, 2)) -> np.ndarray:
    """A seeded (N, 4) point cloud whose voxels are neighbours: filled
    blobs of ``blob`` = (x, y, z) voxels, one jittered point per voxel, as
    many blobs as the voxel cap holds, placed uniformly inside the range.
    ``synthetic_batch_numpy`` scatters its voxels uniformly, so its maps
    are nearly empty (about 1 tap in 6 present); a real sweep's surfaces
    give maps like these."""
    rng = np.random.default_rng(seed)
    pc = cfg.data.point_cloud
    grid = np.asarray(pc.grid_size)                      # (nx, ny, nz)
    blob = np.minimum(np.asarray(blob), grid)
    n_blobs = max(pc.voxel.max_voxels_train // int(np.prod(blob)), 1)
    corners = rng.integers(0, grid - blob + 1, size=(n_blobs, 3))
    cells = np.stack(np.meshgrid(*[np.arange(b) for b in blob],
                                 indexing="ij"), -1).reshape(-1, 3)
    voxels = (corners[:, None, :] + cells[None]).reshape(-1, 3)
    jitter = rng.uniform(0.1, 0.9, size=voxels.shape)
    xyz = (voxels + jitter) * np.asarray(pc.voxel.voxel_size) \
        + np.asarray(pc.range[:3])
    feat = rng.uniform(0, 1, size=(len(xyz), 1))
    return np.concatenate([xyz, feat], 1).astype(np.float32)


def clustered_rulebook_numpy(cfg: Config, seed: int = 0,
                             blob=(10, 10, 2)) -> dict:
    """``clustered_points`` through the voxelizer and the rulebook at the
    config's caps: the batch fields ``voxels``, ``voxel_coords``,
    ``voxel_num_points``, ``voxel_valid`` and ``rulebook`` at batch size 1,
    as ``synthetic_batch_numpy`` lays them out."""
    pc = cfg.data.point_cloud
    cap = pc.voxel.max_voxels_train
    points = clustered_points(cfg, seed, blob)
    vox = Voxelizer(pc.voxel.voxel_size, pc.range,
                    pc.voxel.max_points_per_voxel, cap)(points)
    voxels, coords, num_points, valid = pad_voxels(
        vox, cap, points.shape[1], pc.voxel.max_points_per_voxel)
    nx, ny, nz = pc.grid_size
    rb = build_rulebook(coords, int(valid.sum()), (nz + 1, ny, nx),
                        cfg.model.lidar.max_voxels_per_stage)
    return dict(voxels=voxels[None], voxel_coords=coords[None],
                voxel_num_points=num_points[None], voxel_valid=valid[None],
                rulebook={k: np.asarray(v)[None] for k, v in rb.items()})


# VoxelBackbone8x: (layer, x-window map, stage of the map, stage of the
# table, C, D) of its 11 sparse convs
BACKBONE_LAYERS = (
    ("conv_input", "win_0", 0, 0, 4, 16),
    ("conv1_0", "win_0", 0, 0, 16, 16),
    ("conv2_down", "dwin_1", 1, 0, 16, 32),
    ("conv2_1", "win_1", 1, 1, 32, 32),
    ("conv2_2", "win_1", 1, 1, 32, 32),
    ("conv3_down", "dwin_2", 2, 1, 32, 64),
    ("conv3_1", "win_2", 2, 2, 64, 64),
    ("conv3_2", "win_2", 2, 2, 64, 64),
    ("conv4_down", "dwin_3", 3, 2, 64, 64),
    ("conv4_1", "win_3", 3, 3, 64, 64),
    ("conv4_2", "win_3", 3, 3, 64, 64),
)


# (xd shape, t_pad) of the stem's edge cases: an H_out that no row tile of
# 4 divides with one ragged W tile; a W edge tile beyond a full 128-pixel
# tile with t_pad (3, 2); two clips with t_pad (2, 3)
STEM_EDGE_SHAPES = (((1, 5, 9, 20, 12), (3, 3)),
                    ((1, 4, 8, 140, 12), (3, 2)),
                    ((2, 6, 11, 70, 12), (2, 3)))


def stem_inputs_numpy(shape, seed: int = 0):
    """Seeded (xd, w2, scale, bias) for the stem conv at ``shape``; w2 is a
    valid space-to-depth weight (its structurally zero taps are zero)."""
    from ..ops.kernels.stem_conv import s2d_zero_taps
    rng = np.random.default_rng(seed)
    xd = rng.normal(size=shape).astype(np.float32)
    w2 = (rng.normal(size=(7, 4, 4, 12, 64)) * 0.05).astype(np.float32)
    w2[:, s2d_zero_taps().numpy()] = 0.0
    sc = rng.uniform(0.5, 1.5, size=(64,)).astype(np.float32)
    bi = rng.normal(0, 0.1, size=(64,)).astype(np.float32)
    return xd, w2, sc, bi


WINDOW_ABSENT = 63 << 20          # a window word with all three taps absent


def window_edge_cases(seed: int = 0):
    """(name, features (B, M, C), win (B, R, 9), weights (27, C, D)) numpy
    inputs at the sparse core's edges: R below one tile, R no multiple of
    the 64- or 128-row tiles, a 128-row stretch whose taps are all absent,
    B = 2, R != M, and enough rows for the 128-row tile. Random maps with
    every slot code (3 = absent)."""
    rng = np.random.default_rng(seed)

    def case(b, r, m, c, d, absent=None):
        feats = rng.normal(size=(b, m, c)).astype(np.float32)
        pos = rng.integers(0, m, (b, r, 9)).astype(np.int32)
        sel = rng.integers(0, 64, (b, r, 9)).astype(np.int32)
        win = pos | (sel << 20)
        if absent is not None:
            win[:, absent] = WINDOW_ABSENT
        w = (rng.normal(size=(27, c, d)) / (27 * c) ** .5).astype(np.float32)
        return feats, win, w

    yield ("below one tile", *case(1, 5, 40, 16, 16))
    yield ("ragged last tile", *case(1, 200, 300, 32, 64))
    yield ("an absent stretch", *case(1, 450, 450, 16, 32,
                                      absent=slice(128, 256)))
    yield ("all absent", *case(1, 70, 50, 64, 64, absent=slice(None)))
    yield ("batch of two, R != M", *case(2, 333, 1000, 32, 32))
    yield ("128-row tiles, ragged", *case(1, 34000, 2000, 4, 16,
                                          absent=slice(33000, 33800)))


def window_taps(win) -> int:
    """Taps present in packed x-window maps (slot code != 3), for numpy
    arrays and torch tensors alike."""
    sel = win >> 20
    return sum(int((((sel >> (2 * dx)) & 3) != 3).sum()) for dx in range(3))


# sparse_wgrad's edge cases: name -> (B, R, M, C, D); ``wgrad_edge_inputs``
# shapes the map as the name says. The kernel cuts a launch's rows into
# stretches of 256 (up to 8192 rows), 512 (up to 16384), 1024 (up to 32768)
# or 2048, the centre tap's a quarter as long but at least 128, and walks a
# stretch's present pairs in tiles of 32 to 128.
WGRAD_EDGE_CASES = {
    "a tap no row has": (1, 700, 500, 16, 32),
    "a stretch with no tap present": (1, 1500, 900, 32, 32),
    "only the centre tap": (1, 700, 700, 64, 64),
    "every tap present": (1, 300, 200, 32, 64),
    "one row": (1, 1, 40, 16, 16),
    "one over a centre stretch": (1, 129, 300, 64, 64),
    "one over a stretch": (1, 257, 300, 32, 64),
    "512-row stretches, one over": (1, 8705, 1500, 16, 16),
    "batch of two, ragged tiles": (2, 333, 400, 32, 32),
    "all rows padding": (1, 600, 50, 4, 16),
    "1024-row stretches": (1, 17000, 3000, 16, 32),
    "2048-row stretches, ragged": (2, 16500, 2000, 4, 16),
    "128 channels both sides": (1, 300, 400, 128, 128),
    "a 128-channel merge": (1, 500, 300, 128, 64),
    "a 64 to 128 stride": (1, 400, 600, 64, 128),
    "a decoder's 64 to 32, batch of two": (2, 300, 350, 64, 32),
    "a decoder's 32 to 16": (1, 1100, 800, 32, 16),
    "an importance conv's 64 to 16": (1, 600, 500, 64, 16),
    "256 channels in 128 x 128 pieces, batch of two": (2, 300, 350, 256,
                                                         256),
    "the padded input layer's 8 to 16, batch of two": (2, 900, 600, 8, 16),
}


def wgrad_edge_inputs(name: str, seed: int = 0):
    """Seeded numpy (table (B, M, C), idx (B, R, 27) with -1 absent, dout
    (B, R, D)) of one of ``WGRAD_EDGE_CASES``."""
    b, r, m, c, d = WGRAD_EDGE_CASES[name]
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(b, m, c)).astype(np.float32)
    idx = rng.integers(0, m, (b, r, 27)).astype(np.int32)
    idx[rng.uniform(size=idx.shape) < 0.6] = -1
    dout = rng.normal(size=(b, r, d)).astype(np.float32)
    if name == "a tap no row has":
        idx[:, :, 5] = -1
    elif name == "a stretch with no tap present":
        idx[:, 512:1024] = -1
    elif name == "only the centre tap":
        idx[:] = -1
        idx[:, :, 13] = np.arange(r, dtype=np.int32)
    elif name == "every tap present":
        idx = rng.integers(0, m, (b, r, 27)).astype(np.int32)
    elif name == "all rows padding":
        idx[:] = -1
    elif name == "1024-row stretches":
        idx[:, 9000:] = -1                 # padding rows beyond the occupied
    return table, idx, dout


# row_gather's edge cases: name -> (M, C, R, K). The kernel copies the
# output as float4s, 2 per thread and 512 per block.
ROW_GATHER_EDGE_CASES = {
    "rows the unroll does not divide": (500, 32, 777, 1),
    "width 4": (300, 4, 1001, 3),
    "out of range in the last partial block": (400, 48, 1030, 1),
}


def row_gather_edge_inputs(name: str, seed: int = 0):
    """Seeded numpy (table (M, C), idx (R, K), expected (R, K * C)) of one
    of ``ROW_GATHER_EDGE_CASES``; a row whose index lies outside [0, M) is
    expected as zeros."""
    m, c, r, k = ROW_GATHER_EDGE_CASES[name]
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(m, c)).astype(np.float32)
    idx = rng.integers(0, m, (r, k)).astype(np.int32)
    if name == "out of range in the last partial block":
        idx[-5:, 0] = (-1, m, 2 ** 31 - 1, -7, m + 3)
    inside = (idx >= 0) & (idx < m)
    rows = table[np.where(inside, idx, 0)] * inside[..., None]
    return table, idx, rows.reshape(r, k * c).astype(np.float32)


def cuda_ms_per_launch(fn, launches: int = 20, repeats: int = 5,
                       warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``launches`` calls between one
    pair of CUDA events, divided by their number; the median of ``repeats``
    such runs. The host enqueues ahead of the device, so the per-call host
    work (argument checks, ``torch.empty``, the ctypes call) hides behind
    the kernels as long as one call's kernel outlasts it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def cuda_graph_ms_per_launch(fn, launches: int = 20, repeats: int = 5,
                             warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms that the host cannot pace:
    ``launches`` calls are captured once into a CUDA graph, and the graph's
    replay is timed between one pair of CUDA events; the median of
    ``repeats`` replays over ``launches``. ``fn`` must be capturable: it
    allocates through torch and launches on the current stream, and does
    not synchronise. Where one call's kernel is shorter than the call's
    host work, ``cuda_ms_per_launch`` reads the host's pace and this reads
    the device's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def people_on_voxels(fields: dict, cfg: Config) -> dict:
    """The batch fields with each valid person's 3D box centred on an
    occupied voxel. The synthetic sweep scatters its voxels uniformly over
    the whole range, so boxes placed independently of it find no voxel
    within the grid pool's radii at the flagship range and the sparse
    backbone would get no gradient; in a real sweep people carry their own
    points."""
    pc = cfg.data.point_cloud
    out = dict(fields)
    boxes = fields["boxes3d"].copy()
    for b in range(boxes.shape[0]):
        valid = fields["person_valid"][b]
        coords = fields["voxel_coords"][b][fields["voxel_valid"][b]]
        pick = coords[np.linspace(0, len(coords) - 1, int(valid.sum()))
                      .astype(int)]
        centres = (pick[:, ::-1] + 0.5) * np.asarray(pc.voxel.voxel_size) \
            + np.asarray(pc.range[:3])
        boxes[b, valid, :3] = centres.astype(np.float32)
    out["boxes3d"] = boxes
    return out


class SyntheticClips:
    """An in-memory dataset for the training loop: sample ``i`` is the
    numpy sample dict of ``synthetic_batch_numpy(cfg, 1, seed=first_seed +
    i)`` (its rulebook included), people on occupied voxels, with
    ``frame_id = i`` so that every sample is a frame of its own to the
    evaluator. Nothing is read from disk and nothing is cached: each access
    makes the sample anew, as a decoding dataset does."""

    def __init__(self, cfg: Config, num_samples: int,
                 n_valid: int | None = None, first_seed: int = 0):
        self.cfg = cfg
        self.num_samples = num_samples
        self.n_valid = n_valid
        self.first_seed = first_seed

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, index: int) -> dict:
        if not 0 <= index < self.num_samples:
            raise IndexError(index)
        fields = people_on_voxels(synthetic_batch_numpy(
            self.cfg, 1, self.first_seed + index, self.n_valid), self.cfg)
        sample = {k: (v[0] if not isinstance(v, dict)
                      else {n: a[0] for n, a in v.items()})
                  for k, v in fields.items()}
        sample["frame_id"] = np.int32(index)
        return sample


def batch_from_numpy(fields: dict, device="cpu") -> Batch:
    """A torch Batch on ``device`` from numpy fields."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return Batch(**{k: conv(v) for k, v in fields.items()})


def synthetic_batch(cfg: Config, batch_size: int = 1, seed: int = 0,
                    n_valid: int | None = None, device="cpu") -> Batch:
    """Random but internally consistent padded batch on ``device``."""
    return batch_from_numpy(
        synthetic_batch_numpy(cfg, batch_size, seed, n_valid), device)


def randomize_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every weight and BatchNorm statistic of ``model`` anew.

    Weights get variance 1 / fan_in; norm scales and running variances are
    uniform in [0.5, 1.5] (so no zero-initialised scale leaves a block an
    identity and every variance stays > 0); biases and running means are
    N(0, 0.1). Draws come from the CPU ``generator`` in state_dict order.
    """
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("running_var",) or (t.ndim == 1 and leaf == "weight"):
                v = 0.5 + torch.rand(t.shape, generator=generator)
            elif t.ndim == 1:
                v = 0.1 * torch.randn(t.shape, generator=generator)
            else:
                v = torch.randn(t.shape, generator=generator) \
                    / _fan_in(leaf, t.shape) ** 0.5
            t.copy_(v)


def _fan_in(leaf: str, shape) -> int:
    if leaf[:2] in ("WQ", "WK", "WV"):              # raw (in, out), x @ W
        return shape[0]
    if len(shape) == 3:                             # sparse (27, Cin, Cout)
        return shape[0] * shape[1]
    return int(np.prod(shape[1:]))                  # Linear / conv (out, ...)


# biases that shift every valid row of the next training BatchNorm's input
# alike (through linear maps and the padded-row mask only): the batch mean
# removes them, so their gradient is zero in exact arithmetic and rounding
# noise in any float32 evaluation
BN_CANCELLED_BIASES = tuple(f"{branch}.{layer}.bias"
                            for branch in ("rgb_backbone", "lidar_backbone")
                            for layer in ("embedding", "self_att.W_z",
                                          "self_att.W_z_bn"))


def condition_for_grad_parity_(fields: dict, seed: int = 1) -> dict:
    """Make a tiny_config batch (48 x 64 frames) fit for comparing train-step
    gradients, in place: frames of 16-pixel blocks and person boxes of
    24-40 x 20-32 pixels.

    White-noise frames leave the frozen I3D's 3 x 4 Mixed_4f map nearly
    constant and a small box samples one cell of it, so the RGB non-local
    block sees near-identical rows; its training BatchNorm's
    E[x^2] - E[x]^2 then turns float32 rounding into errors far above any
    tolerance, on every implementation alike.
    """
    rng = np.random.default_rng(seed)
    b, t, h, w, _ = fields["images"].shape
    blocks = rng.normal(size=(b, t, h // 16, w // 16, 3)) * 2
    fields["images"] = np.repeat(np.repeat(blocks, 16, axis=2), 16,
                                 axis=3).astype(np.float32)
    valid = fields["person_valid"]
    xy = rng.uniform(0, [24, 16], size=valid.shape + (2,))
    wh = rng.uniform([24, 20], [40, 32], size=valid.shape + (2,))
    fields["boxes2d"] = (np.concatenate([xy, xy + wh], -1)
                         * valid[..., None]).astype(np.float32)
    return fields


def prepare_grad_parity_(model: torch.nn.Module) -> torch.nn.Module:
    """Dropout off (p = 0) and the RGB non-local block's W_z bias at its
    init value, zero, in place: a random bias dwarfs the spread of W_z's
    output over the rows, and the training BatchNorm after it then
    amplifies rounding by mean^2 / var (~4e4 with it, ~1e2 without)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    w_z = getattr(getattr(model.rgb_backbone, "self_att", None), "W_z", None)
    if w_z is not None:
        with torch.no_grad():
            w_z.bias.zero_()
    return model


def train_loss_and_grads(model: torch.nn.Module, batch: Batch,
                         loss_name: str = "L_total"):
    """One training forward and backward of ``model`` on ``batch``.

    Returns (loss, {parameter name: gradient, zeros where the loss does not
    reach it}, {buffer name: BatchNorm running statistic after the
    forward}); only parameters that require grad are listed.
    """
    from ..train.losses import compute_losses, total_loss
    model.train()
    loss = total_loss(compute_losses(model(batch), batch), loss_name)
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named, grads)}
    stats = {k: v.detach().clone() for k, v in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return loss.detach(), grads, stats


# ---------------------------------------------------------------------------
# the detector zoo
# ---------------------------------------------------------------------------

# the three KITTI classes' mean box sizes (dx, dy, dz), as their anchors
KITTI_SIZES = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))
KITTI_GROUND_Z = -1.73        # the ground under a KITTI lidar, in its frame


class SyntheticKittiFrames:
    """KITTI-like frames made from a seed, for ``assemble_det_batch``
    (data/detbatch.py): ``range`` and ``frame(idx) -> {"points",
    "gt_boxes", "gt_classes"}``. Frame ``idx`` holds ``num_ground`` points
    on a gently sloped ground plane over the whole range and, on each of
    ``num_objects`` boxes of the three KITTI classes (seeded sizes near
    the class means, any yaw, standing on the ground), ``points_per_m2``
    points per square metre of its surface; x, y, z and an intensity in
    [0, 1), in a random order (pcdet's shuffle_points), so that a voxel cap
    keeps a fair share of every object. Seeded by (seed, idx); nothing is
    read from disk."""

    def __init__(self, point_cloud_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
                 num_ground: int = 12000, num_objects: int = 20,
                 points_per_m2: float = 40.0, seed: int = 0):
        self.range = np.asarray(point_cloud_range, np.float32)
        self.num_ground, self.num_objects = num_ground, num_objects
        self.points_per_m2, self.seed = points_per_m2, seed

    def frame(self, idx: int) -> dict:
        rng = np.random.default_rng([self.seed, idx])
        lo, hi = self.range[:3], self.range[3:]
        xy = rng.uniform(lo[:2], hi[:2], (self.num_ground, 2))
        z = KITTI_GROUND_Z + 0.01 * xy[:, :1] + rng.normal(
            0, 0.03, (self.num_ground, 1))
        pts = [np.concatenate([xy, z], 1)]
        n = self.num_objects
        cls = rng.integers(1, 4, n)
        size = np.asarray(KITTI_SIZES)[cls - 1] * rng.uniform(0.9, 1.1, (n, 3))
        ctr = rng.uniform(lo[:2] + 4, hi[:2] - 4, (n, 2))
        zc = KITTI_GROUND_Z + 0.01 * ctr[:, :1] + size[:, 2:3] / 2
        yaw = rng.uniform(-np.pi, np.pi, (n, 1))
        boxes = np.concatenate([ctr, zc, size, yaw], 1).astype(np.float32)
        for b in boxes:
            area = 2 * (b[3] * b[4] + b[3] * b[5] + b[4] * b[5])
            k = int(area * self.points_per_m2)
            local = rng.uniform(-0.5, 0.5, (k, 3))
            face = rng.integers(0, 3, k)
            local[np.arange(k), face] = np.sign(
                local[np.arange(k), face]) * 0.5
            local *= b[3:6]
            c, s = np.cos(b[6]), np.sin(b[6])
            pts.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                                 local[:, 0] * s + local[:, 1] * c + b[1],
                                 local[:, 2] + b[2]], 1))
        xyz = np.concatenate(pts).astype(np.float32)
        keep = np.all((xyz >= lo) & (xyz < hi), axis=1)
        xyz = xyz[keep][rng.permutation(int(keep.sum()))]
        inten = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
        return {"points": np.concatenate([xyz, inten], 1),
                "gt_boxes": boxes, "gt_classes": cls.astype(np.int32)}


def kitti_config(name: str = "SECOND") -> Config:
    """The default Config with the point cloud geometry of detector
    ``name``'s default config (KITTI's range and voxel or pillar size), so
    that ``models.build_model(cfg, name)`` builds that default detector."""
    from ..detection.detectors import default_config
    det = default_config(name)
    cfg = Config()
    pc = dataclasses.replace(
        cfg.data.point_cloud, range=tuple(det.point_cloud_range),
        voxel=dataclasses.replace(cfg.data.point_cloud.voxel,
                                  voxel_size=tuple(det.voxel_size)))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, point_cloud=pc))


# nuScenes at the layout of pcdet tools/cfgs/dataset_configs/
# nuscenes_dataset.yaml (range, voxel size, MAX_SWEEPS, MAX_POINTS_PER_VOXEL,
# the 60,000-voxel cap of its test mode): a 1024 x 1024 x 40 grid
NUSCENES_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
NUSCENES_VOXEL = (0.1, 0.1, 0.2)
NUSCENES_MAX_SWEEPS = 10
NUSCENES_MAX_POINTS_PER_VOXEL = 10
NUSCENES_MAX_VOXELS = 60000
NUSCENES_POINTS_PER_SWEEP = 34720     # the size of a LIDAR_TOP sweep file
# mean (dx, dy, dz) of each detection class in nuScenes' train split
NUSCENES_SIZES = {
    "car": (4.63, 1.97, 1.74), "truck": (6.93, 2.51, 2.84),
    "construction_vehicle": (6.37, 2.85, 3.19), "bus": (10.5, 2.94, 3.47),
    "trailer": (12.29, 2.90, 3.87), "barrier": (0.50, 2.53, 0.98),
    "motorcycle": (2.11, 0.77, 1.47), "bicycle": (1.70, 0.60, 1.28),
    "pedestrian": (0.73, 0.67, 1.77), "traffic_cone": (0.41, 0.41, 1.07)}
NUSCENES_GROUND_Z = -1.84     # the ground under the LIDAR_TOP, in its frame
# the size of the JAX package's nuScenes test tree (tests/test_nuscenes.py:
# two frames of 400 points, one sweep each), over the tiny config's range
TINY_NUSCENES_TREE = dict(num_frames=2, sweeps=2, points_per_sweep=400,
                          num_objects=(3, 5))
TINY_NUSCENES_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
TINY_NUSCENES_VOXEL = (0.25, 0.25, 0.25)


def _box_surface_points(rng, box, k: int) -> np.ndarray:
    """``k`` points drawn on the faces of box (cx, cy, cz, dx, dy, dz,
    yaw)."""
    local = rng.uniform(-0.5, 0.5, (k, 3))
    face = rng.integers(0, 3, k)
    local[np.arange(k), face] = np.sign(local[np.arange(k), face]) * 0.5
    local *= box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    return np.stack([local[:, 0] * c - local[:, 1] * s + box[0],
                     local[:, 0] * s + local[:, 1] * c + box[1],
                     local[:, 2] + box[2]], 1)


def write_nuscenes_tree(root: str, num_frames: int = 4,
                        sweeps: int = NUSCENES_MAX_SWEEPS,
                        points_per_sweep: int = NUSCENES_POINTS_PER_SWEEP,
                        num_objects=(20, 40),
                        point_cloud_range=NUSCENES_RANGE) -> str:
    """Writes a nuScenes-format tree under ``root`` and returns its info
    pickle's name: what data/nuscenes.py: NuScenesDataset reads (the
    runtime layout of pcdet's nuscenes_dataset.py), frame ``i`` drawn from
    the seed (0, i).

    Frame ``i`` is a key frame and ``sweeps - 1`` earlier sweeps, 0.05 s
    apart, each ``points_per_sweep`` points of (x, y, z, intensity, ring)
    in its own lidar frame: a ground plane over the range and, on 20-40
    objects of the ten detection classes (sizes near the class means, any
    yaw, standing on the ground, moving at their velocity), 20 points per
    square metre of their faces, at most 40% of the sweep. The ego moves
    along x, and each sweep's ``transform_matrix`` takes its points into the
    key frame. The info pickle holds ``lidar_path``, ``token``, ``sweeps``
    (``lidar_path``, ``transform_matrix``, ``time_lag``), ``ref_from_car``,
    ``car_from_global``, ``gt_boxes`` (N, 9: centre, size, yaw, vx, vy in
    the key frame's lidar frame), ``gt_names`` and ``num_lidar_pts`` (the
    key frame's points on each object)."""
    import os
    import pickle
    from ..data.nuscenes import NUSCENES_CLASSES
    lo = np.asarray(point_cloud_range[:3], np.float64)
    hi = np.asarray(point_cloud_range[3:], np.float64)
    margin = np.minimum(4.0, 0.2 * (hi[:2] - lo[:2]))
    for sub in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    infos = []
    for i in range(num_frames):
        rng = np.random.default_rng([0, i])
        n = int(rng.integers(num_objects[0], num_objects[1] + 1))
        cls = rng.integers(0, len(NUSCENES_CLASSES), n)
        names = np.asarray([NUSCENES_CLASSES[c] for c in cls])
        size = np.asarray([NUSCENES_SIZES[nm] for nm in names]).reshape(
            n, 3) * rng.uniform(0.9, 1.1, (n, 3))
        ctr = rng.uniform(lo[:2] + margin, hi[:2] - margin, (n, 2))
        zc = NUSCENES_GROUND_Z + size[:, 2:3] / 2
        yaw = rng.uniform(-np.pi, np.pi, (n, 1))
        vel = rng.normal(0.0, 2.0, (n, 2)) * (cls[:, None] < 5)
        boxes = np.concatenate([ctr, zc, size, yaw, vel], 1)
        area = 2 * (size[:, 0] * size[:, 1] + size[:, 0] * size[:, 2]
                    + size[:, 1] * size[:, 2])
        on_obj = (area * 20.0).astype(np.int64)
        if on_obj.sum() > 0.4 * points_per_sweep:
            on_obj = (on_obj * 0.4 * points_per_sweep
                      / on_obj.sum()).astype(np.int64)
        speed = rng.uniform(0.0, 10.0)
        sweep_infos = []
        for k in range(sweeps):
            lag = 0.05 * k
            moved = boxes.copy()
            moved[:, :2] -= vel * lag
            m = points_per_sweep - int(on_obj.sum())
            xy = rng.uniform(lo[:2], hi[:2], (m, 2))
            z = NUSCENES_GROUND_Z + rng.normal(0, 0.03, (m, 1))
            pts = [np.concatenate([xy, z], 1)] + [
                _box_surface_points(rng, b, int(c))
                for b, c in zip(moved, on_obj)]
            xyz = np.concatenate(pts)[rng.permutation(points_per_sweep)]
            # the sweep's lidar stood speed * lag behind the key frame's
            to_key = _yaw_rigid(0.0, (-speed * lag, 0.0, 0.0))
            xyz = xyz - to_key[:3, 3]
            raw = np.concatenate(
                [xyz, rng.uniform(0, 255, (points_per_sweep, 1)),
                 rng.integers(0, 32, (points_per_sweep, 1))],
                1).astype(np.float32)
            rel = (f"samples/LIDAR_TOP/{i:04d}.bin" if k == 0
                   else f"sweeps/LIDAR_TOP/{i:04d}_{k:02d}.bin")
            raw.tofile(os.path.join(root, rel))
            if k == 0:
                key_rel = rel
            else:
                sweep_infos.append({"lidar_path": rel,
                                    "transform_matrix": to_key,
                                    "time_lag": lag})
        infos.append({
            "lidar_path": key_rel, "token": f"nusc_{i}",
            "sweeps": sweep_infos,
            "ref_from_car": _yaw_rigid(0.0, (-0.94, 0.0, -1.84)),
            "car_from_global": _yaw_rigid(
                rng.uniform(-np.pi, np.pi),
                rng.uniform(-500, 500, 3) * (1, 1, 0)),
            "gt_boxes": boxes.astype(np.float32), "gt_names": names,
            "num_lidar_pts": on_obj, "timestamp": float(i)})
    info_name = f"nuscenes_infos_{sweeps}sweeps_train.pkl"
    with open(os.path.join(root, info_name), "wb") as f:
        pickle.dump(infos, f)
    return info_name


# the JAX package's dataset test trees (tests/test_kitti.py, test_nuscenes.py,
# test_waymo_lyft.py, test_once_custom.py, test_pandaset_argo2.py), written
# the same way, for the card's run of each adapter (chip_smoke.py phase 13e)
_KITTI_CALIB = (
    "P0: 707.0 0.0 601.8 0.0 0.0 707.0 183.1 0.0 0.0 0.0 1.0 0.0\n"
    "P1: 707.0 0.0 601.8 0.0 0.0 707.0 183.1 0.0 0.0 0.0 1.0 0.0\n"
    "P2: 707.0 0.0 601.8 45.7 0.0 707.0 183.1 -0.34 0.0 0.0 1.0 0.004\n"
    "P3: 707.0 0.0 601.8 0.0 0.0 707.0 183.1 0.0 0.0 0.0 1.0 0.0\n"
    "R0_rect: 0.9999 0.0098 -0.0074 -0.0098 0.9999 -0.0043 0.0074 0.0043 "
    "0.9999\n"
    "Tr_velo_to_cam: 0.0075 -0.9999 -0.0006 -0.0040 0.0148 0.0007 -0.9998 "
    "-0.0766 0.9998 0.0075 0.0148 -0.2717\n")
_KITTI_LABEL = (
    "Car 0.00 0 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 -0.65 "
    "1.71 46.70 -1.59\n"
    "Pedestrian 0.00 1 -1.41 585.85 180.69 600.30 220.90 1.86 0.60 2.02 "
    "4.59 1.32 45.84 -1.55\n"
    "DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 -1 -1000 -1000 "
    "-1000 -10\n")
PANDASET_POSE = {"position": {"x": 10.0, "y": -5.0, "z": 2.0},
                 "heading": {"w": np.cos(0.3), "x": 0.0, "y": 0.0,
                             "z": np.sin(0.3)}}


def _yaw_rigid(yaw: float, t) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                 [0, 0, 1]]
    m[:3, 3] = t
    return m


def _kitti_tree(root):
    import os
    base = os.path.join(root, "training")
    for sub in ["velodyne", "label_2", "calib"]:
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.default_rng(0)
    pts = rng.uniform([0, -10, -2, 0], [40, 10, 1, 1],
                      size=(512, 4)).astype(np.float32)
    pts.tofile(os.path.join(base, "velodyne", "000000.bin"))
    with open(os.path.join(base, "calib", "000000.txt"), "w") as f:
        f.write(_KITTI_CALIB)
    with open(os.path.join(base, "label_2", "000000.txt"), "w") as f:
        f.write(_KITTI_LABEL)
    return dict(root=str(root), split="train")


def _nuscenes_tree(root):
    import os
    import pickle
    rng = np.random.default_rng(0)
    infos = []
    for i in range(2):
        pts = rng.uniform(-20, 20, (400, 5)).astype(np.float32)
        pts[:, 4] = 0
        rel = f"sweeps/lidar_{i}.bin"
        os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)
        pts.tofile(os.path.join(root, rel))
        sweep_rel = f"sweeps/sweep_{i}.bin"
        spts = rng.uniform(-20, 20, (300, 5)).astype(np.float32)
        spts.tofile(os.path.join(root, sweep_rel))
        gt = np.array([[5.0, 2.0, 0.5, 4.0, 2.0, 1.5, 0.4, 1.0, 0.0],
                       [-8.0, 1.0, 0.3, 0.8, 0.8, 1.8, 0.0, 0.0, 0.0]],
                      np.float32)
        infos.append({
            "lidar_path": rel, "token": f"tok{i}",
            "sweeps": [{"lidar_path": sweep_rel,
                        "transform_matrix": _yaw_rigid(0.01, (0.5, 0, 0)),
                        "time_lag": 0.05}],
            "ref_from_car": _yaw_rigid(0.05, (-0.9, 0.0, -1.8)),
            "car_from_global": _yaw_rigid(0.3 + i, (-100 - i, 50, 0)),
            "gt_boxes": gt,
            "gt_names": np.array(["car", "pedestrian"]),
            "gt_attributes": ["vehicle.moving", "pedestrian.standing"],
            "num_lidar_pts": np.array([50, 20]),
            "timestamp": 0.0})
    with open(os.path.join(root, "infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return dict(root=str(root), info_paths=["infos_train.pkl"], max_sweeps=2)


def _waymo_tree(root):
    import os
    import pickle
    seq = "segment-000"
    os.makedirs(os.path.join(root, "waymo_processed_data", seq))
    rng = np.random.default_rng(0)
    infos = []
    for i in range(3):
        pts = np.zeros((200, 6), np.float32)
        pts[:, :2] = rng.uniform(-30, 30, (200, 2))
        pts[:, 2] = rng.uniform(-1.5, 3.5, 200)
        pts[:, 3] = rng.uniform(0, 4, 200)          # raw intensity
        pts[:, 5] = -1                              # NLZ: keep
        pts[:5, 5] = 1                              # 5 in-NLZ points
        np.save(os.path.join(root, "waymo_processed_data", seq,
                             "%04d.npy" % i), pts)
        pose = np.eye(4)
        c, s = np.cos(0.1 * i), np.sin(0.1 * i)
        pose[:2, :2] = [[c, -s], [s, c]]
        pose[:3, 3] = (2.0 * i, 0, 0)
        infos.append({
            "point_cloud": {"lidar_sequence": seq, "sample_idx": i},
            "frame_id": f"{seq}_{i}", "pose": pose,
            "annos": {
                "name": np.array(["Vehicle", "Pedestrian", "unknown"]),
                "difficulty": np.array([1, 2, 0]),
                "gt_boxes_lidar": np.array(
                    [[5, 1, 0.5, 4, 2, 1.5, 0.2],
                     [-3, 2, 0.2, 0.8, 0.8, 1.7, 0.0],
                     [9, 9, 0, 1, 1, 1, 0]], np.float32),
                "num_points_in_gt": np.array([40, 0, 3])}})
    with open(os.path.join(root, "infos.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return dict(root=str(root), info_paths=["infos.pkl"])


def _lyft_tree(root):
    import os
    import pickle
    infos = []
    rng = np.random.default_rng(1)
    for i in range(2):
        # ragged tail: 3 extra floats beyond a multiple of 5
        pts = rng.uniform(-30, 30, (150, 5)).astype(np.float32)
        pts[:, 2] = rng.uniform(-4.0, 2.0, 150)
        raw = np.concatenate([pts.reshape(-1), np.zeros(3, np.float32)])
        rel = f"lidar_{i}.bin"
        raw.tofile(os.path.join(root, rel))
        infos.append({
            "lidar_path": rel, "token": f"tk{i}", "sweeps": [],
            "gt_boxes": np.array([[2, 1, 0, 4.5, 1.9, 1.6, 0.3]],
                                 np.float32),
            "gt_names": np.array(["car"])})
    with open(os.path.join(root, "infos.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return dict(root=str(root), info_paths=["infos.pkl"])


def _once_tree(root):
    import json
    import os

    def box(x, y):
        return [float(x), float(y), 0.0, 4.0, 2.0, 1.5, 0.0]
    seq = "000027"
    d = os.path.join(root, "data", seq)
    os.makedirs(os.path.join(d, "lidar_roof"))
    rng = np.random.default_rng(0)
    pts = rng.uniform([-20, -20, -3, 0], [20, 20, 2, 1],
                      size=(256, 4)).astype(np.float32)
    pts.tofile(os.path.join(d, "lidar_roof", "1616100000000.bin"))
    anno = {"calib": {"cam01": {}},
            "frames": [{"frame_id": "1616100000000",
                        "pose": [0, 0, 0, 1, 0, 0, 0],
                        "annos": {"names": ["Car", "Pedestrian", "Dog"],
                                  "boxes_3d": [box(5, 0), box(8, 2),
                                               box(0, 0)]}}]}
    with open(os.path.join(d, f"{seq}.json"), "w") as f:
        json.dump(anno, f)
    return dict(root=str(root))


def _pandaset_tree(root):
    import json
    import os
    import pandas as pd
    seq = "001"
    lidar_dir = os.path.join(root, "dataset", seq, "lidar")
    cub_dir = os.path.join(root, "dataset", seq, "annotations", "cuboids")
    os.makedirs(lidar_dir)
    os.makedirs(cub_dir)
    rng = np.random.default_rng(0)
    world = rng.uniform(-20, 20, (300, 3)) + [10.0, -5.0, 2.0]
    pd.DataFrame({
        "x": world[:, 0], "y": world[:, 1], "z": world[:, 2],
        "i": rng.uniform(0, 255, 300), "t": np.zeros(300),
        "d": np.concatenate([np.zeros(200), np.ones(100)])}).to_pickle(
            os.path.join(lidar_dir, "00.pkl.gz"))
    pd.DataFrame({
        "position.x": [12.0, 30.0], "position.y": [-4.0, -5.0],
        "position.z": [2.0, 2.0],
        "dimensions.x": [1.9, 1.9], "dimensions.y": [4.4, 4.4],
        "dimensions.z": [1.6, 1.6],
        "yaw": [0.2, 0.0], "label": ["Car", "Pickup Truck"],
        "cuboids.sensor_id": [-1, -1]}).to_pickle(
            os.path.join(cub_dir, "00.pkl.gz"))
    with open(os.path.join(lidar_dir, "poses.json"), "w") as f:
        json.dump([{"position": PANDASET_POSE["position"],
                    "heading": {k: float(v) for k, v
                                in PANDASET_POSE["heading"].items()}}], f)
    return dict(root=str(root), class_names=("Car",),
                training_categories={"Pickup Truck": "Car"})


def _argo2_tree(root):
    import os
    import pickle
    os.makedirs(os.path.join(root, "training", "velodyne"))
    rng = np.random.default_rng(0)
    infos = []
    for i in range(2):
        pts = rng.uniform(-30, 30, (200, 4)).astype(np.float32)
        pts.tofile(os.path.join(root, "training", "velodyne",
                                f"{i:06d}.bin"))
        infos.append({
            "point_cloud": {"velodyne_path": f"velodyne/{i:06d}.bin"},
            "uuid": f"log{i}/16{i}000",
            "annos": {
                "name": np.array(["REGULAR_VEHICLE", "PEDESTRIAN"]),
                "location": np.array([[5, 1, 0.5], [-3, 2, 0.2]],
                                     np.float32),
                "dimensions": np.array([[4, 2, 1.5], [0.8, 0.8, 1.8]],
                                       np.float32),
                "rotation_y": np.array([0.3, 0.0], np.float32),
                "num_points_in_gt": np.array([40, 12])}})
    with open(os.path.join(root, "infos.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return dict(root=str(root), info_paths=["infos.pkl"])


def _custom_tree(root):
    import os
    os.makedirs(os.path.join(root, "points"))
    os.makedirs(os.path.join(root, "labels"))
    rng = np.random.default_rng(0)
    pts = rng.uniform([-10, -10, -2, 0], [10, 10, 1, 1],
                      size=(128, 4)).astype(np.float32)
    np.save(os.path.join(root, "points", "000.npy"), pts)
    with open(os.path.join(root, "labels", "000.txt"), "w") as f:
        f.write("1.0 2.0 0.0 4.0 2.0 1.5 0.3 Vehicle\n")
        f.write("5.0 5.0 0.0 0.8 0.6 1.7 0.0 Pedestrian\n")
    return dict(root=str(root), class_names=("Vehicle",),
                map_class_to_kitti={"Vehicle": "Car"})


DATASET_TREES = {"KittiDataset": _kitti_tree,
                 "NuScenesDataset": _nuscenes_tree,
                 "WaymoDataset": _waymo_tree, "LyftDataset": _lyft_tree,
                 "ONCEDataset": _once_tree,
                 "PandasetDataset": _pandaset_tree,
                 "Argo2Dataset": _argo2_tree, "CustomDataset": _custom_tree}


def write_dataset_tree(name: str, root) -> dict:
    """Writes the JAX package's test tree of dataset ``name`` (a name of
    data/registry.py) under ``root`` and returns the keyword arguments of
    ``build_dataset(name, **kwargs)`` that the JAX test builds it with.
    PandaSet's tree is pickled by pandas, which it imports."""
    import os
    os.makedirs(root, exist_ok=True)
    return DATASET_TREES[name](root)


def nuscenes_centerpoint_config(tiny: bool = False):
    """CenterPoint as the JAX package composes it (VoxelBackbone8x,
    conv_out, the BEV trunk, one CenterHead task) for nuScenes' ten
    classes at stride 8, with cbgs_voxel01_res3d_centerpoint.yaml's loss
    weights and NMS where DetectorConfig has the field: over NUSCENES_RANGE
    at NUSCENES_VOXEL with the 60,000-voxel stage caps of det_batch's
    default rule, or with ``tiny`` over TINY_NUSCENES_RANGE at the tiny
    configs' widths (tests/test_detection.py: tiny_voxel_cfg)."""
    from ..data.nuscenes import NUSCENES_CLASSES
    from ..detection.dense_heads import CenterHeadConfig
    from ..detection.detectors import default_config
    from ..detection.post import NMSConfig
    head = CenterHeadConfig(class_names=NUSCENES_CLASSES, loc_weight=0.25)
    cfg = dataclasses.replace(
        default_config("CenterPoint"), class_names=NUSCENES_CLASSES,
        point_cloud_range=NUSCENES_RANGE, voxel_size=NUSCENES_VOXEL,
        max_voxels_per_stage=(NUSCENES_MAX_VOXELS, NUSCENES_MAX_VOXELS,
                              NUSCENES_MAX_VOXELS // 2,
                              NUSCENES_MAX_VOXELS // 4),
        center_head=head,
        nms=NMSConfig(nms_type="nms_bev", nms_thresh=0.2,
                      nms_pre_maxsize=1000, nms_post_maxsize=83,
                      score_thresh=0.1))
    if not tiny:
        return cfg
    return dataclasses.replace(
        cfg, point_cloud_range=TINY_NUSCENES_RANGE,
        voxel_size=TINY_NUSCENES_VOXEL,
        max_voxels_per_stage=(256, 256, 128, 64),
        center_head=dataclasses.replace(head, shared_conv_channels=16),
        nms=NMSConfig(nms_pre_maxsize=64, nms_post_maxsize=16,
                      score_thresh=0.05),
        bev_layer_nums=(1, 1), bev_layer_strides=(1, 2),
        bev_num_filters=(32, 32), bev_upsample_strides=(1, 2),
        bev_num_upsample_filters=(32, 32))


def tiny_detector_config(name: str = "SECOND"):
    """The tiny detector configs of the JAX package's tests
    (tests/test_detection.py: tiny_voxel_cfg, tiny_pillar_cfg): a 16 m x
    16 m range, two classes (one for the pillars), narrow BEV blocks."""
    from ..detection.anchors import AnchorClassConfig
    from ..detection.dense_heads import AnchorHeadConfig, CenterHeadConfig
    from ..detection.detectors import default_config
    from ..detection.post import NMSConfig
    base = default_config(name)
    if "Pillar" in name:
        return dataclasses.replace(
            base, class_names=("Car",),
            point_cloud_range=(0.0, -8.0, -2.0, 16.0, 8.0, 2.0),
            voxel_size=(0.5, 0.5, 4.0),
            anchors=(AnchorClassConfig("Car", ((3.9, 1.6, 1.56),),
                                       (0.0, 1.57), (-1.0,), False, 2, 0.55,
                                       0.4),),
            head=AnchorHeadConfig(num_class=1),
            nms=NMSConfig(nms_pre_maxsize=32, nms_post_maxsize=8,
                          score_thresh=0.05),
            bev_layer_nums=(1, 1), bev_layer_strides=(2, 2),
            bev_num_filters=(16, 32), bev_upsample_strides=(1, 2),
            bev_num_upsample_filters=(16, 16), pillar_filters=(16,))
    return dataclasses.replace(
        base, class_names=("Car", "Pedestrian"),
        point_cloud_range=(0.0, -8.0, -1.5, 16.0, 8.0, 1.5),
        voxel_size=(0.25, 0.25, 0.125),
        max_voxels_per_stage=(256, 128, 64, 32),
        anchors=(AnchorClassConfig("Car", ((3.9, 1.6, 1.56),), (0.0, 1.57),
                                   (-1.0,), False, 8, 0.55, 0.4),
                 AnchorClassConfig("Pedestrian", ((0.8, 0.6, 1.73),),
                                   (0.0, 1.57), (-0.6,), False, 8, 0.5,
                                   0.35)),
        head=AnchorHeadConfig(num_class=2),
        center_head=CenterHeadConfig(class_names=("Car", "Pedestrian"),
                                     shared_conv_channels=16),
        nms=NMSConfig(nms_pre_maxsize=64, nms_post_maxsize=16,
                      score_thresh=0.05),
        bev_layer_nums=(1, 1), bev_layer_strides=(1, 2),
        bev_num_filters=(32, 32), bev_upsample_strides=(1, 2),
        bev_num_upsample_filters=(32, 32))


def tiny_roi_config(**over):
    """The tiny RoI head of the JAX package's tests
    (tests/test_detection_roi.py: _tiny_roi_cfg), dropout off."""
    from ..detection.post import NMSConfig
    from ..detection.roi_detectors import RoIHeadConfig
    from ..detection.roi_heads import RoISamplerConfig
    return dataclasses.replace(RoIHeadConfig(
        shared_fc=(32, 32), cls_fc=(16,), reg_fc=(16,), grid_size=3,
        dp_ratio=0.0, sampler=RoISamplerConfig(roi_per_image=16),
        train_nms=NMSConfig(nms_thresh=0.8, nms_pre_maxsize=32,
                            nms_post_maxsize=24, score_thresh=0.0),
        test_nms=NMSConfig(nms_thresh=0.7, nms_pre_maxsize=32,
                           nms_post_maxsize=16, score_thresh=0.0),
        pool_radii=(0.8,), pool_nsamples=(8,), pool_mlps=((16, 16),),
        bev_grid_size=3), **over)


# PV-RCNN++'s vector pools' merge biases reach the loss only through a
# bias-free Linear and a training BatchNorm (the fusion and the point head,
# the RoI head's shared FC), which subtract them again: their gradient is
# zero in exact arithmetic and rounding noise in float32
PVPP_CANCELLED_BIASES = frozenset(
    f"{m}.merge.bias" for m in ("vp_raw_0", "vp_raw_1", "vp_x_conv3",
                                "vp_x_conv4", "vp_roi"))

# the zoo's second slice at the tiny sizes of the port's parity tests
# (tests/test_torch_det_two_stage.py, tests/test_torch_det_next.py)
SECOND_SLICE = ("PVRCNN", "SECONDNetIoU", "PartA2", "PointRCNN", "VoxelNeXt",
                "PV-RCNN++")


def tiny_second_slice_detector(name: str, *, device, generator):
    """Detector ``name`` of SECOND_SLICE at its tiny parity-test config
    (tiny_detector_config's trunk); the point families read 4-channel raw
    points (``tiny_det_batch(..., points=)``)."""
    from ..detection import parta2, point_rcnn, pointnet2, pfe
    from ..detection import pv_rcnn_pp, roi_detectors, voxelnext
    cfg = tiny_detector_config("SECOND")
    kw = dict(device=device, generator=generator)
    if name == "PVRCNN":
        vsa = pfe.VSAConfig(num_keypoints=48, num_output_features=16,
                            sa_layers=(
            pfe.SALayerConfig("raw_points", 1, (0.8, 1.6), (8, 4),
                              ((8, 8), (8,))),
            pfe.SALayerConfig("x_conv2", 2, (1.6,), (8,), ((8,),)),
            pfe.SALayerConfig("x_conv4", 8, (3.2,), (4,), ((8,),))))
        roi = tiny_roi_config(pool_radii=(0.8, 1.6), pool_nsamples=(8, 4),
                              pool_mlps=((8,), (8,)))
        return roi_detectors.PVRCNNDetector(cfg, roi, vsa, **kw)
    if name == "SECONDNetIoU":
        return roi_detectors.SECONDIoUDetector(
            cfg, tiny_roi_config(use_corner_loss=False), **kw)
    if name == "PartA2":
        return parta2.PartA2Detector(cfg, tiny_roi_config(),
                                     parta2.PartA2Config(4, (8,), (8, 8)),
                                     **kw)
    if name == "PointRCNN":
        pn2 = pointnet2.PointNet2Config(
            npoints=(48, 16), radii=((0.8, 1.6), (2.0,)),
            nsamples=((8, 4), (8,)), sa_mlps=(((8, 8), (8,)), ((16,),)),
            fp_mlps=((16,), (16,)))
        pool = point_rcnn.PointRCNNRoIConfig(
            num_sampled_points=24, xyz_up_layer=(8,), sa_npoints=(8, -1),
            sa_radii=(0.8, 100.0), sa_nsamples=(4, 4),
            sa_mlps=((8,), (8, 16)))
        return point_rcnn.PointRCNNDetector(cfg, tiny_roi_config(), pn2,
                                            pool, **kw)
    if name == "VoxelNeXt":
        # the parity test's (8, 8, 16, 16, 16) doubled: widths the sparse
        # kernels are built for
        return voxelnext.VoxelNeXtDetector(cfg, voxelnext.VoxelNeXtConfig(
            channels=(16, 16, 32, 32, 32), out_channel=32,
            max_bev_voxels=64, max_boxes=16), **kw)
    if name == "PV-RCNN++":
        from ..detection.post import NMSConfig
        from ..detection.roi_heads import RoISamplerConfig
        roi = tiny_roi_config(
            shared_fc=(32,), pool_radii=(1.6,),
            sampler=RoISamplerConfig(roi_per_image=8),
            train_nms=NMSConfig(nms_thresh=0.8, nms_pre_maxsize=32,
                                nms_post_maxsize=16, score_thresh=0.0),
            test_nms=NMSConfig(nms_thresh=0.7, nms_pre_maxsize=32,
                               nms_post_maxsize=8, score_thresh=0.0))
        pp = pv_rcnn_pp.PVPPConfig(
            num_keypoints=36, num_sectors=6, vp_mlp=8,
            num_output_features=16, vp_radii=(0.8, 1.6),
            vsa_sources=(("x_conv3", 4, 1.2), ("x_conv4", 8, 2.4)))
        return pv_rcnn_pp.PVRCNNPlusPlusDetector(cfg, roi, pp, **kw)
    raise KeyError(name)


def tiny_det_batch(cfg, batch_size: int = 2, m: int = None, p: int = 5,
                   g: int = 4, seed: int = 3, rulebook: bool = True,
                   device="cpu", points: int = 0):
    """A padded DetBatch at a tiny config, the draws of the JAX package's
    tests/test_detection.py: det_batch (uniform points, one voxel per
    point, duplicates dropped, seeded GT boxes, the last GT slot padded),
    with the host rulebook (nbr and x-window maps) where ``rulebook``;
    ``m`` voxel slots (a rulebook's stage 0 holds
    max_voxels_per_stage[0]); ``points`` raw (x, y, z, intensity) points
    per item, uniform in the range, the last item's final eighth
    padding."""
    from ..detection.detectors import DetBatch
    m = m or (cfg.max_voxels_per_stage[0] if rulebook else 96)
    rng = np.random.default_rng(seed)
    pr = cfg.point_cloud_range
    nx, ny, nz = cfg.grid_size
    pts = rng.uniform(low=[pr[0], pr[1], pr[2], 0.0],
                      high=[pr[3], pr[4], pr[5], 1.0],
                      size=(batch_size, m, p, 4)).astype(np.float32)
    vs = np.asarray(cfg.voxel_size)
    cxyz = ((pts[:, :, 0, :3] - np.asarray(pr[:3])) // vs).astype(np.int32)
    cxyz = np.clip(cxyz, 0, np.asarray([nx - 1, ny - 1, nz - 1]))
    coords = cxyz[..., ::-1].copy()
    num = rng.integers(1, p + 1, size=(batch_size, m)).astype(np.int32)
    valid = np.ones((batch_size, m), bool)
    for b in range(batch_size):
        keys = (coords[b, :, 0].astype(np.int64) * ny + coords[b, :, 1]) \
            * nx + coords[b, :, 2]
        _, first = np.unique(keys, return_index=True)
        dup = np.ones(m, bool)
        dup[first] = False
        valid[b, dup] = False
        coords[b, ~valid[b]] = -1
        order = np.argsort(~valid[b], kind="stable")
        coords[b], pts[b] = coords[b][order], pts[b][order]
        num[b], valid[b] = num[b][order], valid[b][order]
    gt = np.zeros((batch_size, g, 7), np.float32)
    gt[..., 0] = rng.uniform(pr[0] + 2, pr[3] - 2, (batch_size, g))
    gt[..., 1] = rng.uniform(pr[1] + 2, pr[4] - 2, (batch_size, g))
    gt[..., 2] = rng.uniform(-0.5, 0.5, (batch_size, g))
    gt[..., 3:6] = rng.uniform(0.5, 4.0, (batch_size, g, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (batch_size, g))
    gtc = rng.integers(1, len(cfg.class_names) + 1,
                       (batch_size, g)).astype(np.int32)
    gtv = np.ones((batch_size, g), bool)
    gtv[:, -1] = False
    rb = None
    if rulebook:
        rbs = [build_rulebook(c, int(v.sum()), (nz + 1, ny, nx),
                              cfg.max_voxels_per_stage, x_window=True)
               for c, v in zip(coords, valid)]
        rb = {k: torch.from_numpy(np.stack([r[k] for r in rbs])).to(device)
              for k in rbs[0]}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    raw = raw_valid = None
    if points:
        raw = rng.uniform(low=[pr[0], pr[1], pr[2], 0.0],
                          high=[pr[3], pr[4], pr[5], 1.0],
                          size=(batch_size, points, 4)).astype(np.float32)
        raw_valid = np.ones((batch_size, points), bool)
        raw_valid[-1, points - points // 8:] = False
        raw[~raw_valid] = 0.0
        raw, raw_valid = t(raw), t(raw_valid)
    return DetBatch(voxels=t(pts), voxel_coords=t(coords),
                    voxel_num_points=t(num), voxel_valid=t(valid),
                    gt_boxes=t(gt), gt_classes=t(gtc), gt_valid=t(gtv),
                    rulebook=rb, points=raw, point_valid=raw_valid)


# ---------------------------------------------------------------------------
# the zoo's last families at the sizes of their parity tests
# (tests/test_torch_det_caddn.py, test_torch_det_mppnet.py,
# test_torch_det_extras.py)
# ---------------------------------------------------------------------------

# a pinhole with f = 30 and its centre at (32, 16) of a 32 x 64 image, the
# camera axes lidar's permuted (x = -y, y = -z, z = x): the JAX package's
# CaDDN test calibration
TINY_LIDAR_TO_CAM = np.asarray([[0., -1., 0., 0.], [0., 0., -1., 0.],
                                [1., 0., 0., 0.], [0., 0., 0., 1.]],
                               np.float32)
TINY_CAM_TO_IMG = np.asarray([[30., 0., 32., 0.], [0., 30., 16., 0.],
                              [0., 0., 1., 0.]], np.float32)
TINY_CADDN = dict(ddn_arch="compact", num_depth_bins=8, depth_min=1.0,
                  depth_max=17.0, ddn_channels=(8, 16), channel_reduce=8,
                  bev_collapse_channels=16, downsample_factor=4)
TINY_MPPNET = dict(num_frames=4, num_groups=2, points_per_roi=16, hidden=16,
                   num_heads=2, num_layers=2, mixer_hidden=8)


def tiny_caddn(*, device, generator):
    """CaDDN at the JAX package's test config: the compact DDN, a 64 x 64 x
    4 grid at the tiny detector range, anchors at stride 2."""
    from ..detection.caddn import CaDDNConfig, CaDDNDetector
    base = tiny_detector_config("SECOND")
    cfg = dataclasses.replace(
        base, name="CaDDN", voxel_size=(0.25, 0.25, 0.75),
        anchors=tuple(dataclasses.replace(a, feature_map_stride=2)
                      for a in base.anchors),
        bev_layer_nums=(1, 1), bev_layer_strides=(2, 2),
        bev_num_filters=(16, 32), bev_upsample_strides=(1, 2),
        bev_num_upsample_filters=(16, 16))
    return CaDDNDetector(cfg, CaDDNConfig(**TINY_CADDN), device=device,
                         generator=generator)


def tiny_caddn_batch(cfg, batch_size: int = 2, seed: int = 2, device="cpu"):
    """tiny_det_batch at ``cfg`` with a 32 x 64 image per item in [0, 1),
    the tiny calibration (the second item's focal length 5 % longer) and a
    depth map uniform in [1, 17)."""
    rng = np.random.default_rng(seed)
    h, w = 32, 64
    k = np.stack([TINY_CAM_TO_IMG * np.float32(1.0 + 0.05 * i)
                  for i in range(batch_size)])
    k[:, 2] = TINY_CAM_TO_IMG[2]
    batch = tiny_det_batch(cfg, batch_size, m=16, rulebook=False)
    return dataclasses.replace(
        batch,
        images=torch.from_numpy(rng.uniform(0, 1, (batch_size, h, w, 3))
                                .astype(np.float32)),
        lidar_to_cam=torch.from_numpy(np.repeat(TINY_LIDAR_TO_CAM[None],
                                                batch_size, 0)),
        cam_to_img=torch.from_numpy(k),
        depth_maps=torch.from_numpy(rng.uniform(1, 17, (batch_size, h, w))
                                    .astype(np.float32))).to(device)


def mppnet_inputs(b: int = 2, t: int = 4, n: int = 96, r: int = 5,
                  seed: int = 0) -> dict:
    """numpy inputs of MPPNet: points around the RoIs of a drifting
    trajectory, frame points (B, T, N, 4) with the last 10 of item 1
    padding, RoIs (B, T, R, 7) with item 1's last RoI a padded (zero) row,
    trajectory validity with two unmatched frames, three GT boxes per item
    (item 1's last padding) near the current RoIs, and the proposals'
    labels."""
    rng = np.random.default_rng(seed)
    rois = np.zeros((b, t, r, 7), np.float32)
    rois[:, 0, :, 0] = rng.uniform(2, 14, (b, r))
    rois[:, 0, :, 1] = rng.uniform(-6, 6, (b, r))
    rois[:, 0, :, 2] = rng.uniform(-0.5, 0.5, (b, r))
    rois[:, 0, :, 3:6] = rng.uniform(1, 4, (b, r, 3))
    rois[:, 0, :, 6] = rng.uniform(-np.pi, np.pi, (b, r))
    for i in range(1, t):
        rois[:, i] = rois[:, i - 1]
        rois[:, i, :, :2] += rng.normal(0, 0.3, (b, r, 2))
        rois[:, i, :, 6] += rng.normal(0, 0.05, (b, r))
    pts = np.zeros((b, t, n, 4), np.float32)
    for i in range(t):
        owner = rng.integers(0, r, (b, n))
        ctr = np.take_along_axis(rois[:, i, :, :3], owner[..., None], 1)
        pts[:, i, :, :3] = ctr + rng.normal(0, 1.0, (b, n, 3))
        pts[:, i, :, 3] = rng.uniform(0, 1, (b, n))
    pv = np.ones((b, t, n), bool)
    pv[1, :, -10:] = False
    roi_valid = np.ones((b, r), bool)
    roi_valid[1, -1] = False
    rois[1, :, -1] = 0.0
    traj_valid = np.ones((b, t, r), bool)
    traj_valid[0, 2, 1] = traj_valid[1, 3, 0] = False
    traj_valid &= roi_valid[:, None]
    gt = rois[:, 0, :3].copy()
    gt[..., :2] += rng.normal(0, 0.2, (b, 3, 2))
    gt_valid = np.asarray([[True, True, True], [True, True, False]])
    labels = rng.integers(1, 4, (b, r)).astype(np.int32)
    return dict(fp=pts, pv=pv, rois=rois, rv=roi_valid, tv=traj_valid,
                gt=gt, gtc=np.ones((b, 3), np.int32), gtv=gt_valid,
                labels=labels)


def sparse_input_numpy(seed: int = 0, m: int = 60, c: int = 8,
                       shape=(1, 16, 16)):
    """Two items of ``m`` random sites of ``shape`` with ``c`` features,
    duplicates dropped (padding rows last, coords -1): (features, coords,
    valid, shape)."""
    rng = np.random.default_rng(seed)
    feats, coords, valid = [], [], []
    for _ in range(2):
        cz = np.stack([rng.integers(0, s, m) for s in shape], -1)
        keys = (cz[:, 0] * shape[1] + cz[:, 1]) * shape[2] + cz[:, 2]
        _, first = np.unique(keys, return_index=True)
        v = np.zeros(m, bool)
        v[first] = True
        order = np.argsort(~v, kind="stable")
        cz, v = cz[order].astype(np.int32), v[order]
        cz[~v] = -1
        feats.append(rng.normal(size=(m, c)).astype(np.float32) * v[:, None])
        coords.append(cz)
        valid.append(v)
    return np.stack(feats), np.stack(coords), np.stack(valid), tuple(shape)


def _flat_outputs(out, prefix=""):
    """(name, tensor) of every tensor in a module's output: tensors,
    SparseTensors' features, nested dicts, lists and tuples."""
    from ..models.sparse_backbone import SparseTensor
    if isinstance(out, torch.Tensor):
        yield prefix, out
    elif isinstance(out, SparseTensor):
        yield f"{prefix}features", out.features
    elif isinstance(out, dict):
        for k in sorted(out):
            yield from _flat_outputs(out[k], f"{prefix}{k}/")
    else:
        for i, o in enumerate(out):
            yield from _flat_outputs(o, f"{prefix}{i}/")


def card_vs_cpu(build, args, loss_fn=None, device="cuda", tol: float = 1e-4,
                noise_tol: float = 1e-3):
    """A module built by ``build(device)`` on the CPU (plain versions) and
    on ``device`` (kernels, cuDNN) with the CPU one's weights
    (``randomize_``), on the same
    ``args`` (tensors, SparseTensors or DetBatches): the eval outputs
    (integer ones equal) and, where ``loss_fn(model, training outputs,
    args)`` is given, every gradient and new statistic of one training
    forward and backward, each within ``tol`` of its largest CPU value. A
    gradient below ``noise_tol`` of the largest one on the CPU (zero in
    exact arithmetic: a bias a norm or a softmax cancels) must be so on
    ``device`` too. Returns (tensors compared, worst relative error);
    raises AssertionError on a mismatch."""
    from ..models.sparse_backbone import SparseTensor

    def to(a, dev):
        if isinstance(a, SparseTensor):
            return dataclasses.replace(a, features=a.features.to(dev),
                                       coords=a.coords.to(dev),
                                       valid=a.valid.to(dev))
        return a.to(dev)
    cpu = build("cpu")
    # weights of variance 1 / fan_in everywhere: an init's small heads
    # (normal(0.001)) would hold outputs at the scale of rounding
    randomize_(cpu, torch.Generator().manual_seed(1))
    card = build(device)
    card.load_state_dict(cpu.state_dict())           # before any forward
    runs = []
    for model, dev in ((cpu, "cpu"), (card, device)):
        a = [to(x, dev) for x in args]
        with torch.no_grad():
            ev = dict(_flat_outputs(model.eval()(*a)))
        grads = {}
        if loss_fn is not None:
            model.train()
            loss_fn(model, model(*a), a).backward()
            grads = {k: p.grad for k, p in model.named_parameters()
                     if p.grad is not None}
            grads.update({f"statistic {k}": t
                          for k, t in model.named_buffers()})
        runs.append((ev, grads))
    (ev_c, gr_c), (ev_g, gr_g) = runs
    worst, n = 0.0, 0

    def compare(what, got, ref):
        nonlocal worst, n
        got = got.detach().cpu().double()
        ref = ref.detach().double()
        scale = max(float(ref.abs().max()), 1e-30) if ref.numel() else 1.0
        rel = float((got - ref).abs().max()) / scale if ref.numel() else 0.0
        assert rel <= tol, f"{what}: rel err {rel:.3g} > {tol:g}"
        worst, n = max(worst, rel), n + 1
    for k, ref in ev_c.items():
        if ref.is_floating_point():
            compare(f"eval {k}", ev_g[k], ref)
        else:
            assert torch.equal(ev_g[k].cpu(), ref), f"eval {k} differs"
    largest = max([float(g.abs().max()) for k, g in gr_c.items()
                   if not k.startswith("statistic")] or [0.0])
    for k, ref in gr_c.items():
        if not k.startswith("statistic") \
                and float(ref.abs().max()) <= noise_tol * largest:
            assert float(gr_g[k].abs().max()) <= noise_tol * largest, \
                f"grad {k}: noise on the CPU, not on {device}"
            continue
        compare(k if k.startswith("statistic") else f"grad {k}", gr_g[k],
                ref)
    return n, worst


# ---------------------------------------------------------------------------
# the two learning checks (the JAX package's tests/test_overfit.py and
# tests/test_detection_overfit.py), run by tests/test_torch_overfit.py on
# the CPU and by chip_smoke.py phase 13g on the card
# ---------------------------------------------------------------------------

def learnable_batch(cfg: Config, device="cpu") -> Batch:
    """A fixed 2-clip set whose labels are consistent with the inputs
    (tests/test_overfit.py: _learnable_batch): two spatially separated
    groups (2D boxes overlap within a group, never across; 3D centres
    clustered) and one action class per actor, so every loss term can
    reach zero."""
    base = synthetic_batch_numpy(cfg, batch_size=2)
    valid = base["person_valid"]
    b, n = valid.shape
    h, w = cfg.data.image_size
    rng = np.random.default_rng(42)
    sgid = np.full((b, n), -1, np.int32)
    boxes2d = np.zeros((b, n, 4), np.float32)
    boxes3d = base["boxes3d"].copy()
    actions = np.zeros((b, n, 27), np.float32)
    centers2d = [(w * 0.2, h * 0.5), (w * 0.8, h * 0.5)]
    centers3d = [(-4.0, -4.0), (4.0, 4.0)]
    for bi in range(b):
        for i in np.flatnonzero(valid[bi]):
            g = int(i % 2)
            cx, cy = centers2d[g]
            jx, jy = rng.uniform(-3, 3, 2)
            boxes2d[bi, i] = [cx + jx - 8, cy + jy - 12,
                              cx + jx + 8, cy + jy + 12]
            boxes3d[bi, i, 0:2] = np.asarray(centers3d[g]) \
                + rng.uniform(-0.4, 0.4, 2)
            boxes3d[bi, i, 2] = 0.0
            sgid[bi, i] = g
            actions[bi, i, int(i % 3)] = 1.0      # one pose-1 class each
    return batch_from_numpy(dict(
        base, boxes2d=boxes2d, boxes3d=boxes3d, social_group_id=sgid,
        actions=actions, social_group_activity=actions), device)


def overfit_mgar(device="cpu", max_steps: int = 800, variables=None,
                 fall: float = 10.0) -> dict:
    """MGAR at tiny_config trained on ``learnable_batch`` with Adam at 2e-3
    (no accumulation, no decay), judged every 50 steps from step 100 on,
    until the eval-mode L_total has fallen ``fall`` times and the train-set
    grouping AP (eval/ap.py: set_detection_ap over the decoded groups) is
    1, or ``max_steps``; returns the eval losses before and after, the
    steps taken and the AP. The weights start from flax-layout
    ``variables`` where given (the JAX test's init), else from the port's
    seed-0 draw."""
    from ..convert import load_jax_variables
    from ..eval.ap import set_detection_ap
    from ..models.mgar import MGAR
    from ..ops.grouping import decode_group_ids
    from ..train.losses import compute_losses, total_loss
    from ..train.train_state import (make_eval_step, make_optimizer,
                                     make_train_step)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=1, lr_decay_gamma=1.0))
    stage = dataclasses.replace(cfg.train.stages[0], learning_rate=2e-3)
    batch = learnable_batch(cfg, device)
    model = MGAR(cfg, device=device,
                 generator=torch.Generator().manual_seed(0))
    if variables is not None:
        load_jax_variables(model, variables)
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad],
                         stage, steps_per_epoch=1000, grad_accum=1,
                         gamma=1.0)
    step = make_train_step(model, opt, "L_total")
    eval_step = make_eval_step(model)
    valid = batch.person_valid.cpu()
    boxes2d = batch.boxes2d.cpu().numpy()
    gt_gid = batch.social_group_id.cpu().numpy()

    def evaluate():
        """(eval L_total, train-set grouping AP)."""
        out = eval_step(batch)
        with torch.inference_mode():
            loss = float(total_loss(compute_losses(out, batch), "L_total"))
        dets, gts = [], []
        for b in range(valid.shape[0]):
            v = valid[b].numpy()
            pred = decode_group_ids(out.a_theta[b].cpu(), valid[b]).numpy()
            for g in np.unique(pred[v]):
                dets.append((b, boxes2d[b][(pred == g) & v], 1.0))
            for g in np.unique(gt_gid[b][v & (gt_gid[b] >= 0)]):
                gts.append((b, boxes2d[b][(gt_gid[b] == g) & v]))
        return loss, set_detection_ap(dets, gts)
    loss0, ap = evaluate()
    loss, steps = loss0, 0
    for i in range(max_steps):
        metrics = step(batch)
        steps = i + 1
        if not np.isfinite(float(metrics["loss"])):
            raise FloatingPointError(f"non-finite loss at step {i}")
        if i % 50 == 49:
            loss, ap = evaluate()
            if i >= 100 and loss <= loss0 / fall and ap == 1.0:
                break
    loss, ap = evaluate()
    return {"loss0": loss0, "loss": loss, "steps": steps, "group_ap": ap}


def overfit_second(device="cpu", steps: int = 200) -> dict:
    """SECOND at the tiny voxel config trained on one fixed scene
    (tests/test_detection_overfit.py: the seed-3 det_batch of 64 voxels and
    three GT slots, the maps built without a rulebook) for ``steps``
    clipped AdamW steps at 3e-3; returns the first and last losses and, of
    the eval forward's top detection, its score and its BEV distance to
    the nearest valid GT centre."""
    from ..detection import build_detector
    from ..detection.train import create_det_train_state, make_det_train_step
    cfg = tiny_detector_config("SECOND")
    model = build_detector("SECOND", cfg, device=device,
                           generator=torch.Generator().manual_seed(0))
    batch = tiny_det_batch(cfg, batch_size=1, m=64, g=3, seed=3,
                           rulebook=False, device=device)
    step = make_det_train_step(model, create_det_train_state(model))
    first = last = None
    for i in range(steps):
        last = float(step(batch)["loss"])
        first = last if i == 0 else first
    model.eval()
    with torch.no_grad():
        out = model.predict(model(batch))
    top = int(torch.argmax(out["scores"][0]))
    box = out["boxes"][0, top, :2].cpu().numpy()
    gt = batch.gt_boxes[0, batch.gt_valid[0], :2].cpu().numpy()
    return {"first": first, "last": last, "steps": steps,
            "top_score": float(out["scores"][0, top]),
            "top_to_gt_m": float(np.linalg.norm(gt - box[None],
                                                axis=1).min())}
