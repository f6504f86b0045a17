"""Typed configuration tree of MGAR: the port's config classes, with the
same keys and defaults (the port's YAML loading left out: the benchmark
sets fields from its configuration file).

Keys marked "JAX package only" steer TPU workarounds there; the port keeps
them so the YAML files load unchanged, and ignores them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Data / input pipeline
# ---------------------------------------------------------------------------

@dataclass
class VoxelizationConfig:
    """Voxelizer settings (reference: mil3.yaml DATA_PROCESSOR transform_points_to_voxels)."""
    voxel_size: Tuple[float, float, float] = (0.1, 0.1, 1.25)
    max_points_per_voxel: int = 5
    max_voxels_train: int = 16000
    max_voxels_test: int = 40000

    def max_voxels(self, training: bool) -> int:
        return self.max_voxels_train if training else self.max_voxels_test


@dataclass
class PointCloudConfig:
    """Point-cloud pipeline (reference: mil3.yaml train.augmentation.point_cloud + ranges)."""
    num_points: int = 35000
    range: Tuple[float, float, float, float, float, float] = (
        -100.0, -100.0, -25.0, 100.0, 100.0, 25.0)
    num_point_features: int = 4  # x, y, z, intensity
    shuffle_train: bool = True
    voxel: VoxelizationConfig = field(default_factory=VoxelizationConfig)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) = round((range_max - range_min) / voxel_size).

        Reference: data_processor.py:134-135. mil3.yaml => (2000, 2000, 40).
        """
        vs = self.voxel.voxel_size
        return tuple(
            int(round((self.range[i + 3] - self.range[i]) / vs[i])) for i in range(3)
        )


@dataclass
class DataConfig:
    """Dataset layout + per-sample padding (reference: dataloader.py:16-77, mil3.yaml DATALOADER)."""
    root: str = ""
    image_size: Tuple[int, int] = (720, 1280)  # (H, W) after resize
    num_frames: int = 15
    num_boxes: int = 100          # MAX people per scene, padded
    num_actions: int = 27
    crop_size: int = 5            # RoIAlign output size
    point_cloud: PointCloudConfig = field(default_factory=PointCloudConfig)
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # STRICT-COMPAT (reference dataloader.py:264): the reference reads the
    # action/activity labels from the FIRST frame of the 15-frame clip while
    # boxes/ids come from the key frame. False (default) = labels from the
    # key frame (the fix); True = bug-compatible clip-start labels.
    actions_from_clip_start: bool = False
    # JPEG DCT-domain pre-scaling on decode (PIL Image.draft): near-free
    # power-of-two downscale inside libjpeg when the source is >= 2x the
    # target size; a no-op otherwise. False = full decode + bilinear only
    # (bit-parity with the reference's torchvision Resize path).
    jpeg_draft: bool = True
    # Ship raw uint8 frames to the device and normalize there (MGAR entry):
    # 4x fewer host->device bytes per clip and no host float math. False =
    # host-side float normalize (the reference's torchvision pipeline).
    images_uint8: bool = False


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass
class RGBBackboneConfig:
    """Reference: mil3.yaml RGB_BACKBONE + gat_model.py:973-1095."""
    i3d_endpoint: str = "Mixed_4f"
    i3d_freeze: bool = True
    embedding_dim: int = 512
    inter_person: bool = False
    two_stage_att: bool = False
    gat_module: bool = False
    i3d_checkpoint: Optional[str] = None   # converted Kinetics weights (.npz); None = random init
    # JAX package only: which stem implementation its eval path takes. The
    # port's stem is always ops/kernels/stem_conv.py.
    pallas_stem: bool = True
    # JAX package only: rematerialise the I3D Inception modules in the
    # backward pass.
    i3d_remat: bool = False
    # JAX package only: eval-path (3,3,3) convs as 3 temporally shifted 2D
    # convs; the same sums.
    i3d_t2d: bool = False
    # JAX package only: post-stem I3D convs in bfloat16.
    i3d_bf16_body: bool = False
    # temporal-cone culling of the Mixed_4x modules to the backward cone of
    # Mixed_4f's center slice — the only slice the model consumes
    # (gat_model.py:1050). Exact (value-identical features); Mixed_4f runs
    # 1/4 of its temporal positions at the flagship T=15. Eval-only (the
    # rgb backbone gates it off under train-mode BN).
    i3d_center_slice: bool = True
    # JAX package only: bf16 product split of its stem kernel (1 | 2 | 3).
    pallas_stem_passes: int = 1
    # JAX package only: variants of its stem kernel (patch order, output
    # layout, how the input window arrives); identical sums.
    pallas_stem_dimajor: bool = False
    pallas_stem_cmajor: bool = False
    pallas_stem_pipelined: bool = True
    # JAX package only: eval-path batched I3D as batched stem + per-clip
    # body. Exact under eval-mode BN.
    i3d_batch_unroll: bool = True


@dataclass
class PoolLayerConfig:
    """One ROI-grid pooling scale (reference: mil3.yaml ROI_GRID_POOL.POOL_LAYERS.x_convK)."""
    source: str = "x_conv2"
    mlps: Tuple[int, int] = (32, 32)
    query_range: Tuple[int, int, int] = (4, 4, 4)  # (z, y, x) half-window in voxels
    radius: float = 0.4
    nsample: int = 16
    pool_method: str = "max_pool"


@dataclass
class LiDARBackboneConfig:
    """Reference: mil3.yaml LiDAR_BACKBONE + gat_model.py:868-971."""
    grid_pool_size: int = 6        # 6x6x6 grid points per box
    shared_fc: Tuple[int, ...] = (512, 512)
    dp_ratio: float = 0.3
    pool_layers: Tuple[PoolLayerConfig, ...] = (
        PoolLayerConfig("x_conv2", (32, 32), (4, 4, 4), 0.4, 16),
        PoolLayerConfig("x_conv3", (32, 32), (4, 4, 4), 0.8, 16),
        PoolLayerConfig("x_conv4", (32, 32), (4, 4, 4), 1.6, 16),
    )
    self_att_use: bool = True
    self_att_dim: int = 3
    self_att_inter_person: bool = False
    two_stage_att: bool = False
    embedding_dim: int = 512
    # Max active voxels per downsampling stage (static shapes). Stage 0 covers
    # stride-1 voxels (bounded by voxelizer max_voxels); later stages shrink.
    max_voxels_per_stage: Tuple[int, int, int, int] = (16000, 16000, 8000, 4000)
    # STRICT-COMPAT: False (default) = approximate top-k neighbor selection
    # in the JAX package (recall ~0.99); True = bitwise scan-order parity
    # with the reference voxel_query CUDA kernel. The port selects exactly.
    voxel_query_exact: bool = False
    # Per-box spatial cull for the grid-pool voxel query
    # (ops/voxel.py:voxel_query_boxed): each ROI queries only its
    # pool_cull_k nearest voxels instead of the full per-scale voxel set.
    # Exact whenever <= pool_cull_k active voxels lie within reach of the
    # box (people-sized ROIs occupy a few hundred; the K-nearest cull ball
    # must cover the query-reach ball, so dense crowds at the stride-2
    # scale are the binding case). 0 disables the cull (dense (R, M)
    # relation + row gathers).
    pool_cull_k: int = 256
    # JAX package only: approximate top-k for the grid pool's first-nsample
    # neighbor selection (recall ~0.99) instead of the exact top_k over
    # (N*G3, cull_k); False = exact. The port always selects exactly.
    pool_approx_nsample: bool = True
    # x-window sparse-conv gathers (sparse_backbone.window_gather): 9 wide
    # window gathers per query instead of 27 row gathers, using the packed
    # maps the host rulebook emits (data/rulebook.py). Requires the host
    # rulebook; falls back to the nbr/down maps when they are absent.
    x_window: bool = True
    # JAX package only: fuse the x-window gather + tap GEMM of every
    # submanifold layer into one kernel there. The port always runs the
    # fused kernel (ops/kernels/window_conv.py).
    x_window_fused: bool = False


@dataclass
class FusionConfig:
    """Reference: mil3.yaml GAR_MODEL + gat_model.py:1130-1699."""
    modality: str = "Multi"              # RGB | LiDAR | Multi
    fusion: str = "Attention_mat"        # DAFM; also sum/concat/crossAtt/Attention_normal/...
    sigma: float = 10.0
    feat_norm: bool = True
    euclidean: bool = True
    ind_action_concat: bool = True
    sg_feat_org: bool = False
    feature_dim: int = 1024              # action-head input dim (RGB||LiDAR concat)
    hidden_dim: int = 512                # SG-head input dim
    sim: str = "cosine"                  # cosine | Graph | Graph2 | Graph3 | Graph4
    num_fusion_layers: int = 2
    # Social_Layer / Social_Encoder (gat_model.py:1144-1147): transform the
    # fused features before the cosine similarity. none | mlp | encoder
    social_layer: str = "none"


@dataclass
class ModelConfig:
    rgb: RGBBackboneConfig = field(default_factory=RGBBackboneConfig)
    lidar: LiDARBackboneConfig = field(default_factory=LiDARBackboneConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    dtype: str = "float32"               # compute dtype for backbones


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass
class StageConfig:
    """One training stage (reference: mil3.yaml TRAINER.STAGE_1/2)."""
    epochs: int = 50
    learning_rate: float = 1e-3
    loss: str = "L_total"                # L_total | L_g | L_bce | L_bce2 | L_act


@dataclass
class TrainConfig:
    batch_size: int = 1
    shuffle: bool = True
    seed: int = 2023
    grad_accum_steps: int = 8            # reference: train_func.py:262-269
    lr_decay_gamma: float = 0.9          # reference: 0.9**epoch LambdaLR
    stages: Tuple[StageConfig, ...] = (
        StageConfig(50, 1e-3, "L_total"),
        StageConfig(0, 3e-4, "L_total"),
    )
    save_path: str = "checkpoints"
    eval_every_epochs: int = 1
    log_every_steps: int = 8
    num_workers: int = 0                 # decode processes (reference
    # train_func.py:506 uses 4); 0 = single producer thread. Size so that
    # host clips/s >= device clips/s.


@dataclass
class MeshConfig:
    """Device-mesh layout of the JAX package's sharding (in place of
    nn.DataParallel at train_func.py:512 and pcdet's dormant DDP infra).
    The port lays it over the processes of a ``torch.distributed`` group,
    one per card (parallel/mesh.py: ``make_mesh``); a single process
    ignores it."""
    data: int = -1                        # -1 = all devices on the data axis
    fsdp: int = 1                         # optional parameter sharding axis


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
