"""Offline dataset tooling: info-pickle and GT-database builders.

Capability parity with the reference's one-time preparation steps
(pcdet/datasets/kitti/kitti_dataset.py:150-471 — ``get_infos``,
``create_groundtruth_database``, ``create_kitti_infos``): given a raw
KITTI-layout tree, emit

  - ``kitti_infos_<split>.pkl``: the pcdet info format (point_cloud /
    image / calib 4x4 matrices / annos with camera-frame annotations,
    ``gt_boxes_lidar`` and ``num_points_in_gt``);
  - ``gt_database/<frame>_<name>_<i>.bin`` center-relative object point
    crops plus ``kitti_dbinfos_<split>.pkl`` — the sampling database the
    GT-sampling augmentor (data/augmentor.py GTDatabaseSampler) consumes.

Host-side numpy throughout (these are offline builders, not the jit path);
the in-box point test reuses the augmentor's rotated-box membership
(roiaware_pool3d points_in_boxes_cpu equivalent).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .augmentor import _points_in_boxes_host
from .kitti import (KittiDataset, boxes_camera_to_lidar, load_velodyne,
                    parse_calib, parse_label)


def _calib_info(calib) -> Dict[str, np.ndarray]:
    """3x4 / 3x3 calib blocks -> the 4x4 matrices pcdet stores
    (kitti_dataset.get_infos:163-171)."""
    p2 = np.vstack([calib.P2, [0., 0., 0., 1.]]).astype(np.float32)
    r0 = np.zeros((4, 4), np.float32)
    r0[3, 3] = 1.0
    r0[:3, :3] = calib.R0
    v2c = np.vstack([calib.V2C, [0., 0., 0., 1.]]).astype(np.float32)
    return {"P2": p2, "R0_rect": r0, "Tr_velo_to_cam": v2c}


def build_kitti_frame_info(base: str, frame_id: str,
                           has_label: bool = True,
                           count_inside_pts: bool = True) -> Dict:
    """One frame's pcdet-format info dict (get_infos.process_single_scene
    :153-219). DontCare objects sort to the tail with index -1; lidar boxes
    and point counts cover real objects only."""
    calib = parse_calib(os.path.join(base, "calib", f"{frame_id}.txt"))
    # per-frame image size (the reference reads it via PIL in get_infos;
    # KITTI frames vary: 370x1224, 374x1238, 375x1242, ...)
    image_shape = np.array([375, 1242], np.int32)
    img_path = os.path.join(base, "image_2", f"{frame_id}.png")
    if os.path.exists(img_path):
        from PIL import Image
        with Image.open(img_path) as im:
            image_shape = np.array([im.height, im.width], np.int32)
    info: Dict = {
        "point_cloud": {"num_features": 4, "lidar_idx": frame_id},
        "image": {"image_idx": frame_id, "image_shape": image_shape},
        "calib": _calib_info(calib),
    }
    if not has_label:
        return info
    objs = parse_label(os.path.join(base, "label_2", f"{frame_id}.txt"))
    objs = ([o for o in objs if o.cls_type != "DontCare"]
            + [o for o in objs if o.cls_type == "DontCare"])
    num_obj = sum(o.cls_type != "DontCare" for o in objs)
    annos: Dict = {
        "name": np.array([o.cls_type for o in objs]),
        "truncated": np.array([o.truncation for o in objs]),
        "occluded": np.array([o.occlusion for o in objs]),
        "alpha": np.array([o.alpha for o in objs]),
        "bbox": (np.stack([o.box2d for o in objs])
                 if objs else np.zeros((0, 4), np.float32)),
        "dimensions": np.array([[o.l, o.h, o.w] for o in objs],
                               np.float32).reshape(-1, 3),  # camera lhw
        "location": (np.stack([o.loc for o in objs])
                     if objs else np.zeros((0, 3), np.float32)),
        "rotation_y": np.array([o.ry for o in objs], np.float32),
        "score": np.zeros(len(objs), np.float32),
        "difficulty": np.array([o.difficulty for o in objs], np.int32),
        "index": np.array(list(range(num_obj))
                          + [-1] * (len(objs) - num_obj), np.int32),
    }
    annos["gt_boxes_lidar"] = boxes_camera_to_lidar(objs[:num_obj], calib)
    if count_inside_pts:
        pts = load_velodyne(os.path.join(base, "velodyne",
                                         f"{frame_id}.bin"))
        # reference counts FOV points only (get_infos:204-216 get_fov_flag)
        uv, depth = calib.lidar_to_img(pts[:, :3])
        h_img, w_img = info["image"]["image_shape"]
        fov = ((uv[:, 0] >= 0) & (uv[:, 0] < w_img) & (uv[:, 1] >= 0)
               & (uv[:, 1] < h_img) & (depth > 0))
        inside = _points_in_boxes_host(pts[fov], annos["gt_boxes_lidar"])
        npts = -np.ones(len(objs), np.int32)
        npts[:num_obj] = inside.sum(axis=1)
        annos["num_points_in_gt"] = npts
    info["annos"] = annos
    return info


def create_kitti_infos(root: str, save_path: Optional[str] = None,
                       splits: Sequence[str] = ("train", "val"),
                       with_test: bool = False) -> Dict[str, str]:
    """create_kitti_infos (kitti_dataset.py:431-471): one info pickle per
    split (+ trainval when both halves exist). Returns {split: pkl path}."""
    save_path = save_path or root
    os.makedirs(save_path, exist_ok=True)
    out: Dict[str, str] = {}
    by_split: Dict[str, List[Dict]] = {}
    for split in list(splits) + (["test"] if with_test else []):
        ds = KittiDataset(root, split=split)
        has_label = split != "test"
        infos = [build_kitti_frame_info(ds.base, fid, has_label=has_label,
                                        count_inside_pts=has_label)
                 for fid in ds.ids]
        by_split[split] = infos
        path = os.path.join(save_path, f"kitti_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        out[split] = path
    if "train" in by_split and "val" in by_split:
        path = os.path.join(save_path, "kitti_infos_trainval.pkl")
        with open(path, "wb") as f:
            pickle.dump(by_split["train"] + by_split["val"], f)
        out["trainval"] = path
    return out


def create_groundtruth_database(root: str, info_path: str,
                                split: str = "train",
                                used_classes: Optional[Sequence[str]] = None
                                ) -> str:
    """create_groundtruth_database (kitti_dataset.py:224-276): crop each
    object's points (center-relative xyz) into
    gt_database[_<split>]/<frame>_<name>_<i>.bin and write
    kitti_dbinfos_<split>.pkl. Returns the dbinfos path."""
    sub = "gt_database" if split == "train" else f"gt_database_{split}"
    db_dir = os.path.join(root, sub)
    os.makedirs(db_dir, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)

    base = os.path.join(root, "testing" if split == "test" else "training")
    all_db: Dict[str, List[Dict]] = {}
    for info in infos:
        fid = info["point_cloud"]["lidar_idx"]
        annos = info.get("annos")
        if annos is None:
            continue
        points = load_velodyne(os.path.join(base, "velodyne", f"{fid}.bin"))
        boxes = annos["gt_boxes_lidar"]
        inside = _points_in_boxes_host(points, boxes)
        for i in range(len(boxes)):
            name = str(annos["name"][i])
            fname = f"{fid}_{name}_{i}.bin"
            obj = points[inside[i]].copy()
            obj[:, :3] -= boxes[i, :3]
            obj.tofile(os.path.join(db_dir, fname))
            if used_classes is not None and name not in used_classes:
                continue
            all_db.setdefault(name, []).append({
                "name": name, "path": os.path.join(sub, fname),
                "image_idx": fid, "gt_idx": i,
                "box3d_lidar": boxes[i].copy(),
                "num_points_in_gt": int(len(obj)),
                "difficulty": int(annos["difficulty"][i]),
                "bbox": annos["bbox"][i].copy(),
                "score": float(annos["score"][i])})
    db_path = os.path.join(root, f"kitti_dbinfos_{split}.pkl")
    with open(db_path, "wb") as f:
        pickle.dump(all_db, f)
    return db_path


def load_dbinfos(db_path: str, root: Optional[str] = None,
                 num_features: int = 4) -> Dict[str, List[Dict]]:
    """Load a pcdet-style dbinfos pickle and materialize each entry's
    ``points`` from its .bin ``path`` — the in-memory structure
    GTDatabaseSampler consumes (data/augmentor.py:143-162)."""
    root = root or os.path.dirname(os.path.abspath(db_path))
    with open(db_path, "rb") as f:
        db = pickle.load(f)
    for entries in db.values():
        for e in entries:
            if "points" in e:
                continue
            raw = np.fromfile(os.path.join(root, e["path"]), np.float32)
            e["points"] = raw.reshape(-1, num_features)
    return db
