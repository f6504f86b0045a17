"""The voxelrcnn cell at a tiny size for the CPU: a 12.8 x 12.8 m crop at
KITTI's voxels (32 x 32 BEV locations, 2,048 anchors 0.4 m apart, as dense
as the cell's), narrow BEV and RoI layers, the proposal NMS cut in the
YAML's ratio (9000 -> 512 as 176 -> 10, or as 1760 -> 100 where the
faults have to show: at 10 of 2,048 random-scored anchors the top ones
rarely touch, so the NMS keeps them whatever its threshold or pre-size),
600-point frames with 2-4 cars. Shared by h100_bench/tests and the port's
tests/ (imported by path)."""
import copy

TINY_CONFIG = {
    "detector": {"point_cloud_range": [0.0, -6.4, -3.0, 12.8, 6.4, 1.0],
                 "voxel_size": [0.05, 0.05, 0.1],
                 "bev_layer_nums": [1, 1], "bev_num_filters": [8, 16],
                 "bev_num_upsample_filters": [16, 16]},
    "roi_head": {"num_rois_train": 8, "shared_fc": [16, 16],
                 "cls_fc": [16, 16], "reg_fc": [16, 16], "grid_size": 2,
                 "sampler": {"roi_per_image": 8},
                 "train_nms": {"nms_pre_maxsize": 176,
                               "nms_post_maxsize": 10}},
    "grid_pool": {"pool_cull_k": 64, "pool_layers": [
        {"source": "x_conv2", "mlps": [8, 8], "query_range": [2, 2, 2],
         "radius": 0.8, "nsample": 4, "pool_method": "max_pool"},
        {"source": "x_conv3", "mlps": [8, 8], "query_range": [2, 2, 2],
         "radius": 1.6, "nsample": 4, "pool_method": "max_pool"},
        {"source": "x_conv4", "mlps": [8, 8], "query_range": [2, 2, 2],
         "radius": 3.2, "nsample": 4, "pool_method": "max_pool"}]},
    "voxelization": {"max_voxels_train": 512},
    "stage_caps": {"train": [512, 2048, 2048, 1024]},
}
TINY_MIX = {"range": [0.0, -6.4, -3.0, 12.8, 6.4, 1.0], "points": 600,
            "cars": [2, 4], "car_range_m": [3.0, 11.0], "car_gap_m": 3.5,
            "car_points_at_10m": 120, "car_points_min": 20,
            "clutter_points": 100, "wall_offset_m": [3.0, 6.0],
            "trees": [2, 4], "max_gt": 8}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) \
            and isinstance(base.get(k), dict) else v
    return out


FAULT_NMS = (1760, 100)


def tiny_spec(seed: int, device: str = "cpu", pool: int = 4,
              nms=(176, 10)) -> dict:
    """The voxelrcnn-train-b2 cell's spec at the tiny size, the proposal
    NMS at ``nms`` (pre, post)."""
    import run
    spec = copy.deepcopy(run.cell_spec("voxelrcnn-train-b2", seed, device))
    spec["config"] = _merge(spec["config"], TINY_CONFIG)
    spec["config"]["roi_head"]["train_nms"].update(
        nms_pre_maxsize=nms[0], nms_post_maxsize=nms[1])
    spec["mix"]["params"].update(TINY_MIX)
    spec["mix"]["pool"] = pool
    return spec
