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


def tiny_det_batch(cfg, batch_size: int = 2, m: int = None, p: int = 5,
                   g: int = 4, seed: int = 3, rulebook: bool = True,
                   device="cpu"):
    """A padded DetBatch at a tiny config, the draws of the JAX package's
    tests/test_detection.py: det_batch (uniform points, one voxel per
    point, duplicates dropped, seeded GT boxes, the last GT slot padded),
    with the host rulebook (nbr and x-window maps) where ``rulebook``;
    ``m`` voxel slots (a rulebook's stage 0 holds
    max_voxels_per_stage[0])."""
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
    return DetBatch(voxels=t(pts), voxel_coords=t(coords),
                    voxel_num_points=t(num), voxel_valid=t(valid),
                    gt_boxes=t(gt), gt_classes=t(gtc), gt_valid=t(gtv),
                    rulebook=rb)
