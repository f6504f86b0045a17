#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multimodal_gar_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from multimodal_gar_tpu_torch/csrc/ into
multimodal_gar_tpu_torch/build/, then:

  1. prints the card (nvidia-smi name and power limit);
  2. builds the seven kernel libraries at once (one nvcc each) and prints
     the build seconds and ptxas usage; counts the HGMMA, UTMALDG and
     UBLKCP instructions of the wgmma kernels (the bf16 stem, the bf16
     window_conv and K3 forward, kernel C, kernel D's instances at D = 64)
     in each library's cuobjdump -sass and fails where one has no HGMMA or
     no UTMALDG, or where ptxas reports a spill for one;
  3. holds the stem and the x-window sparse conv against their plain
     PyTorch versions at the mil3 shapes (the stem at one 15 x 720 x 1280
     clip, the sparse conv at all 11 layers of VoxelBackbone8x over two
     40k-cap flagship rulebooks: the synthetic batch's uniformly scattered
     voxels, which the main paths run, and a clustered cloud whose voxels
     are neighbours, each against the bound of its own present taps) and
     times both with CUDA events; beside the stem it times F.conv3d alone,
     on the space-to-depth input and on the original 3-channel stride-2
     form (the library yardstick, used nowhere in the port);
  3b. holds the index-map sparse conv (K3) against its plain version as the
     forward of all 11 layers over the 40k rulebook's nbr_k / down_k maps
     and as the data gradient of 10 layers over the transposed maps of a
     16k training rulebook, and the weight gradient (K4) for all 11 layers
     of that rulebook and of a clustered 16k rulebook, each layer against
     the bound of its own present taps and twice for equal bits; times each
     with CUDA events, K4 also as a replayed CUDA graph;
  3d. holds K3, window_conv and K4 at 3 point features (xyz only), padded
     to their (4, 16) instances (ops/kernels/_pad.py), against their
     plain versions at the unpadded width over the 16k rulebook's first
     layer, twice for equal bits, replayed from a CUDA graph beside their
     bound and the bare (4, 16) instance;
  3c. holds the row gather against advanced indexing (exactly) at the
     shapes of the gather-probe tool's probes A and E, the shifted-table
     x-window conv at probe F's shape and K3 at probe B's shape against
     their plain versions, and times each beside torch.index_select where
     that computes the same function: per call, and both as replayed CUDA
     graphs; splits the host's cost of one row-gather call into its pieces;
  3e. holds the grid pool's gather backward (neighbour_gather: inverse
     map and segmented-sum kernel) against its plain version (index_put_
     with accumulation) at the three scales of a mil3 training micro-step
     at the 16k cap, (1, 21,600, 16, 32) with M = 16k, 8k and 4k: 53
     padded boxes masked with every row on one voxel, a few kept entries
     at x_conv2, none at x_conv3, a third kept and a 5,600-entry row at
     x_conv4; twice for equal bits, the stats against a bincount, timed
     per call and as a replayed CUDA graph beside its byte bound and
     index_add_ (the library yardstick, used nowhere in the port);
  3f. holds the rotated-BEV NMS kernels (ops/kernels/nms_bev.py: the
     suppression words and the sweep) against their plain versions on the
     CPU at the main paths' sizes: Voxel R-CNN's 9000 training proposals
     at 0.8, clustered about 40 cars and laid on the RPN's anchor grid;
     SECOND's 1024 and CenterPoint's 500 test-time boxes at 0.7; the
     sweep alone under circle_nms at 500. A word bit may differ from the
     CPU's only where that pair's CPU IoU lies within NMS_MARGIN of the
     threshold, the card's sweep equals the CPU sweep of the card's words
     exactly, and the keep masks are equal wherever no bit differs; twice
     for equal bits; the whole nms_bev call at 9000 allocates under 64 MB
     of its own; each kernel timed per call and replayed from a CUDA
     graph, beside the plain words on the card, the plain sweep on the
     host and the least bytes' bound;
  4. runs the whole MGAR eval forward at tiny_config on the card (kernels)
     and on the CPU (plain versions) with the same seeded weights, and
     compares every output;
  4a. does the same for every other configuration the port accepts, at
     tiny_config: the five other configs/*.yaml, each remaining fusion
     name, each learned similarity, both social layers, the non-euclidean
     adjacency head, sg_feat_org without ind_action_concat, the three
     RGB and three LiDAR backbone attention variants, the dense and the
     exact grid-pool query, the mean pool and the trainable I3D;
  4b. runs one train step's forward and backward at tiny_config on the card
     and on the CPU (same weights and batch, dropout off) and compares the
     loss, every parameter gradient and the new BatchNorm statistics;
  5. serves 3 requests of the full-width slice (flagship_config: 720x1280,
     15 frames, 100 actors, 40k voxels, random seeded weights) through the
     eval step, checks the outputs and that each request launched the stem
     kernel once and the x-window sparse conv 11 times;
  5b. serves the same 3 requests on the nbr-map path (x_window off): each
     launches K3 11 times and the x-window kernel never, and the outputs
     match the x-window path's;
  6. trains at full width (flagship_config at the 16k training cap, b1,
     grad_accum_steps 8, L_total, dropout on) for 16 micro-steps: each
     launches the stem once, the x-window conv 11 times, K3 10 times, K4
     11 times and the gather backward once a grid-pool scale (3); the loss
     stays finite, no gradient is non-finite, and the parameters move only
     at micro-steps 8 and 16;
  6b. serves 3 requests (40k cap) and trains 2 micro-steps (16k cap) at full
     width for mil3 and each of the five other shipped configs: outputs
     finite and well-formed, the launch counts per request and per
     micro-step as the modality predicts (the stem only where RGB runs;
     window_conv, K3, K4 and the gather backward only where LiDAR runs),
     and the request's and the micro-step's device time by CUDA events
     (utils/profiling.time_fn) beside the host clock, with peak memory;
  7. runs the gather-probe tool's own entry point at its default sizes
     (multimodal_gar_tpu_torch/tools/probe_gather.py: main) and checks that
     the row gather, the shifted-table conv and K3 were launched;
  8. drives the train / eval entry points at full width: run_training on
     in-memory synthetic clips (8 training clips at the 16k cap, 2
     validation clips at the 40k cap, batch 1, accumulation 2, one stage of
     two epochs, L_total, dropout on) with no decode workers; the same run
     cut after epoch 0, and that epoch again with train.num_workers 4: both
     end in the same weights and optimizer state, bit for bit, and each
     prints its training epochs' clips per second beside the device's own
     rate; the cut run resumed equals the uninterrupted one; then run_eval on the first workdir (the same metrics, exactly)
     and run_training again with resume (no further step); then one run
     with model.rgb.i3d_checkpoint set to a state dict the script writes
     under the published key names: the I3D holds the file's tensors and
     its features are those of an I3D loaded with them directly. Checks the
     optimizer updates, the launch counts, the metrics and the files
     written, and prints the seconds of each part and the host seconds per
     clip of the rulebook;
  9. drives the switches that have their own paths, at full width: (a) 3
     requests of the 40k batch without a rulebook: the maps the sparse
     backbone builds on the card equal the host rulebook's exactly, their
     build is timed by CUDA events beside the host rulebook's seconds, each
     request launches K3 11 times, the x-window conv never and the stem
     once, and its outputs are bit for bit the nbr-map request's; then 4
     micro-steps at 16k without a rulebook (K3 21 = 11 forward + 10 data
     gradient, K4 11 each) after one whose gradients equal, to 1e-6, those
     over the host maps; (b) 3 requests each with the culled, the dense
     (pool_cull_k 0) and the exact grid-pool query on the people-on-voxels
     batch, the others held to the culled one to 1e-4, with the queries
     whose neighbour sets differ counted and the dense query's peak memory
     per scale; (c) 8 micro-steps with a trainable I3D (accumulation 8),
     i3d_remat off and on: losses equal to 1e-5, the I3D's weights move at
     the 8th micro-step only and its statistics at each, the stem kernel is
     not launched in training and once in an eval request of the trained
     model, micro-step times by CUDA events and peak memory both ways; (d)
     at tiny_config, card against CPU: the forward without a rulebook, the
     three legacy models and a trainable-I3D train step;
  10. drives the detector zoo's first slice (models/registry.py:
     build_model with each detector's name, weights from seed 0) on
     synthetic KITTI-like frames (utils/testing.py: SyntheticKittiFrames,
     through data/detbatch.py at 5 points per voxel and a 16,000-voxel
     cap): (a) SECOND at its default config (grid 1408 x 1600 x 40, BEV
     200 x 176, 211,200 anchors): 3 requests (eval forward + predict) on
     the nbr-map path, K3 11 each, then the same on the x-window path
     (window_conv 11, K3 0; outputs within 1e-4 of the nbr path's) and
     without a rulebook (bit for bit the nbr path's), then 4 train steps at
     batch 2 (K3 21 = 11 forward + 10 data gradient, K4 11), with request,
     predict, NMS and step times by CUDA events and peak memory; (b)
     VoxelRCNN-Det the same way (3 requests with 100 RoIs, the grid pool's
     time; 4 train steps with 128 sampled RoIs); (c) PointPillar,
     PillarNet (no sparse kernel) and CenterPoint (K3 as SECOND): one
     request and two train steps each; (d) the KITTI R40 evaluation
     (eval/kitti_eval.py) of (a)'s predictions with every box in the NMS
     (random weights score below the threshold); (e) at the JAX tests' tiny
     configs, every family card against CPU: eval outputs, predict,
     losses, gradients and new statistics;
  11. drives the zoo's second slice the same way, each family at its
     default (KITTI) config and published widths on the same frames:
     PV-RCNN (2048 keypoints, 5 SA sources + BEV, a 6^3 RoI grid),
     SECONDNetIoU (a 7^2 BEV grid), PartA2 (UNetV2, a 12^3 part pool),
     PointRCNN (16,384 points, SA 4096 / 1024 / 256 / 64), VoxelNeXt
     (channels 16 / 32 / 64 / 128 / 128, 4,000 BEV voxels) and PV-RCNN++
     (2048 keypoints in 6 sectors): (a) 3 requests at batch 1 and 4 train
     steps at batch 2 each, request and step ms by CUDA events, peak
     memory after the warm-up, K3 / window_conv / K4 launches per request
     and per step as each family's sparse layers predict; a split by stage
     of a PV-RCNN request (FPS, VSA, RoI grid pool, NMS) and of a PointRCNN
     request (FPS per SA level, ball query, proposal NMS); PartA2 also
     with `x_window` (its encoder on the x-window kernel, outputs held to
     the nbr path's); (b) every K3 and
     K4 launch of a PartA2 request, a PartA2 step and a VoxelNeXt step at
     batch 2 replayed against its plain version; (c) with 10e, each family
     at its tiny parity-test config card against CPU;
  12. drives the rest of the model side: (a) CaDDN at CaDDN.yaml's widths
     (grid 280 x 376 x 25, the DeepLabV3-ResNet101 DDN, a 375 x 1242
     synthetic image with a KITTI-like calibration and the depth map of
     the frame's projected points): 3 b1 requests and 3 b2 steps (the
     first times cuDNN), a request split by stage, the DDN trunk's FLOPs
     beside its bound; (b) MPPNet at mppnet_4frames.yaml's head widths on
     4 frames of 150,000 synthetic points with 128 trajectories: 3 b1
     requests, 3 b2 steps (forward, loss, backward, clipped AdamW), then
     MPPNetE2E online over 8 frames linked by generate_trajectory, ms per
     frame; (c) DynamicPillarVFE and PillarRes18Backbone (32 / 64 / 128 /
     256) on 16,384-point frames at PointPillar's grid, BaseBEVBackboneV1
     on 248 x 216 x 128 and 124 x 108 x 256 maps, AnchorHeadMulti on
     SECOND's 200 x 176 x 512 BEV map, FocalSparseConv on x_conv1-3 of
     SECOND's trunk: 3 b1 requests and 3 b2 training passes each, K3 / K4
     launches per call as EXTRAS_LAUNCHES says; (d) every K3 and K4 launch
     of (c)'s training passes replayed against its plain version, the
     (256, 256), (64, 16) and (16, 64) instances twice for equal bits,
     each timed from a CUDA graph beside its bound; (e) each new family
     and module at its parity-test size card against CPU; (f) VGG16,
     VGG19 and InceptionV3Features at 224 and 299, b8; (g) (c)'s
     PillarRes18Backbone and three FocalSparseConvs at bf16 (12c's
     weights): 3 b1 requests and 3 b2 steps, 23 bf16 forward launches a
     request, 23 forward, 23 kernel C and 23 kernel D a step, every bf16
     launch of one step replayed against its plain version (_bf16_replay:
     kernel D twice for equal bits), the pairs past VoxelBackbone8x's
     ((256, 256), (128, 128), (64, 32), (32, 16), (64, 16); kernel C's
     transposes) timed from a CUDA graph beside their bf16 bound;
  13. drives the dataset side (data/registry.py, the nuScenes adapter, the
     NDS suite) with a full-width nuScenes CenterPoint: (a) writes a
     nuScenes tree (utils/testing.py: write_nuscenes_tree: 4 key frames of
     10 sweeps of 34,720 points, 5 features with the time lag), builds it
     through the registry and times det_batches at b1 onto the card per
     frame on the host clock, frame 0 split into reading, voxelizing, the
     rulebook and the upload, with the voxels, the sites per stage and the
     sites cut off by the caps (0.1 x 0.1 x 0.2 m over 102.4 x 102.4 x 8 m,
     a 1024 x 1024 x 40 grid, 10 points per voxel, 60,000 voxels); (b)
     CenterPoint at nuscenes_centerpoint_config (one CenterHead over the
     ten classes at stride 8, 5 input features: the sparse kernels' (8, 16)
     instances on a zero-padded table) serves 3 b1 requests on the nbr-map
     path (K3 11) and 3 with x_window (window_conv 11, outputs within 1e-4
     of the nbr path's), request ms by CUDA events, peak after the
     warm-up; (c) one warm-up and 3 b2 train steps (K3 21, K4 11); (d)
     every K3 / window_conv / K4 launch of (b) and (c) replayed against its
     plain version, the input layer's launches twice for equal bits and
     replayed from a CUDA graph beside their present-taps bound, the bare
     (8, 16) kernel and the other route (a table padded to 16 on the (16,
     16) instance) beside them; (e) card against CPU at the JAX tests'
     sizes: a tiny 5-feature CenterPoint on a test-size nuScenes tree, and
     the KITTI, Waymo, Lyft, ONCE, Argoverse 2, custom and (where pandas
     imports) PandaSet test trees through the registry onto the card and a
     tiny SECOND at each point width; (f) the NDS evaluation of (b)'s
     predictions, host seconds; (g) the two learning checks
     (utils/testing.py: overfit_mgar, overfit_second), steps and seconds;
  14. drives the parallel layer (multimodal_gar_tpu_torch/parallel/) and
     the input layer at 9-15 point features: (a) a process group of one
     over NCCL (localhost, a free port), eight micro-steps at the 16k cap
     with accumulation 8 through the mesh path against the same eight
     without a mesh (parameters, moments and BatchNorm statistics to 1e-6
     of each leaf's largest), micro-step ms both ways and the gradient
     all-reduce's bytes and ms; (b) two processes on the one card over
     gloo (utils/parallel_testing.py: spawn), a global batch of 2 at full
     width split b1 per rank, three micro-steps against one process's b2
     micro-steps on the same batch (losses, gradients and parameters to
     1e-4 of each leaf's largest), each rank's stem / window_conv / K3 / K4
     launches of the last micro-step replayed against their plain versions;
     (c) a SECOND b2 step at KITTI's widths through shard_det_batch at
     world 2 against one process's; (d) K3, window_conv and K4 at widths
     9-15 over the 16k rulebook's first layer against their plain versions,
     replayed from a CUDA graph beside their bound and the bare (12, 16) or
     (16, 16) instance, and a Waymo tree with sequence_offset (-3, 0) (9
     features) through det_batches into a 9-feature CenterPoint request;
  15. serves at model.dtype bfloat16: (a) the bf16 stem kernel against its
     plain version at the full-width shape, every element within one bf16
     ulp (utils/testing.py: bf16_ulp_check; plus one ulp of the sum before
     the bias, which the second rounding carries), its ms beside F.conv3d
     in bf16 (the library yardstick) and the float32 kernel's, and at B = 2
     with an H and W that no tile divides and an odd Wp; each twice for
     equal bits; (b) the bf16 window_conv and K3 forward per layer on the
     synthetic and the clustered 40k rulebooks, within one bf16 ulp and
     twice for equal bits, graph-replayed ms beside the float32 kernel's
     and the bf16 bound, then both at the sparse core's edges
     (utils/testing.py: window_edge_cases: fewer rows than one tile and
     than 132 tiles, a 128-row stretch and a whole launch with no tap
     present, B = 2, R != M), K3 over the same maps decoded; (c) a tiny
     bf16 MGAR card vs CPU within 2e-2 of each output's largest value;
     (d) 3 full-width bf16
     requests on each sparse path by CUDA events beside the float32
     request, with peak memory, the outputs held to the float32 ones on the
     card (backbone features 5e-2, a_theta 2e-2 of their largest float32
     value; finite, padded rows zero, a_theta's diagonal 1) and each
     request's launches the bf16 kernels' only; (e) SECOND (nbr maps),
     CenterPoint and PartA2 (x-window; PartA2's UNetV2 decoder on the bf16
     forward core) and VoxelNeXt (31 residual and shared layers up to 128
     channels) at KITTI's widths in bf16: 3 requests each, launching
     BF16_DET_REQUEST's counts and no float32 sparse kernel, every bf16
     sparse launch of one replayed against its plain version within one
     bf16 ulp, the wide pairs' graph-replayed ms beside their bf16 bound,
     the gaps to the float32 request; during PartA2's requests a 200 ms
     capture asked of utils/profiling.py's start_server over HTTP, whose
     trace must name the bf16 forward core's and window_conv's kernels;
     (f) run_eval at model.dtype bfloat16
     inside phase 8 on its checkpoint and validation clips, and `python -m
     multimodal_gar_tpu_torch eval --set model.dtype=bfloat16` through its
     main, on the card by default, over a small on-disk synthetic JRDB;
  16. trains at model.dtype bfloat16: (a) kernel C (the bf16 data gradient,
     each tap's product rounded to bf16 before the float32 sum) for the 10
     data-gradient layers and kernel D (the bf16 weight gradient, the
     float32 sum rounded once) for the 11 layers of the synthetic and the
     clustered 16k training rulebooks against their plain versions
     (kernel C within one bf16 ulp of the largest tap product entering
     each element, kernel D within one ulp and twice for equal bits),
     graph-replayed ms and thread-block cluster size per layer beside the
     float32 K3 data gradient and K4 and the bf16 bound (kernel D given
     each map's tap columns, as in training); (b) a tiny bf16 train step
     card vs CPU (each
     loss term and BatchNorm statistic within 2e-2, every gradient finite,
     each sparse weight gradient non-zero, each leaf's distance printed);
     (c) 16 full-width bf16 micro-steps at the 16k cap, accumulation 8, on
     each sparse path (1 bf16 stem, 11 bf16 forward, 10 kernel C and 11
     kernel D launches each, no float32 sparse kernel; finite; the
     parameters moving at micro-steps 8 and 16 only), ms by CUDA events,
     one more micro-step split into forward / losses / backward / guard +
     accumulation beside a float32 micro-step's, peak GiB; (d) two
     micro-steps with a trainable I3D at bf16 (no stem kernel, finite I3D
     gradients); (e) SECOND (nbr maps), CenterPoint, PartA2 (x-window) and
     VoxelNeXt b2 train steps at KITTI's widths at bf16, launching
     BF16_DET_STEP's counts, every bf16 sparse launch of one step replayed
     against its plain version (kernel D twice for equal bits), the wide
     pairs timed as in 15e, beside the float32 step; (f)
     `python -m multimodal_gar_tpu_torch train --set model.dtype=bfloat16`
     through its main on the card over the synthetic JRDB of 15f, its
     float32 checkpoint served by `eval` at both dtypes; (g) 13g's MGAR
     learning check at bf16, held to 13g's gate.

    python3 chip_smoke.py --sweep

adds the host measurements of the decode pool to phase 8, which take
several minutes and check nothing a run without them does not: one sample
through the pool's transport (a pickled message from a forked child through
a SimpleQueue), the input pipeline alone with 0 and 4 decode workers, and
the seeded epoch once more with 8 workers.

Phases 5, 5b, 6, 6b, 7, 8, each full-width path of 9, 10a-10c, 11a,
12a-12c, 12g, 13b, 13c, 13g, 14a, 14b, 14c, 14d's Waymo request, 15d,
15e, 15f and 16b-16g drive the main paths (14b's and 14c's in their
ranks' processes, whose counts come back with their results): the launch counts are set to 0 just before each
and read just after. A kernel's time ("ms") is that of
one launch in a run of 20 launches between one pair of CUDA events, so the
wrapper's host work hides behind the kernels; the time of a single call
between its own pair of events ("per call"), which carries the wrapper, is
printed beside it. Where a kernel is shorter than its call's host work (K4's
light layers, the row gather at one row per query) that run is paced by the
host, and "graph replay" is the same run of launches captured in a CUDA
graph and replayed: the device's own time. Each kernel's bound is the larger
of its least bytes over the card's 3.35 TB/s and its operations over the
card's 67 TFLOP/s float32 rate (NVIDIA's H100 SXM data sheet), computed
from this run's inputs: for the sparse kernels only the taps present in the
maps count; the bf16 kernels' operations (phases 15 and 16) count at the
card's 989 TFLOP/s dense bf16 rate. Any failure raises and the script exits
non-zero. The line before the last is a JSON object with each kernel's
numbers; the last line is {"ok": true, "device": {...}}. Without a CUDA
device it exits 1 at once. The lines "wide pair ..." before them give each
pair past VoxelBackbone8x's of the three bf16 kernels: its launches
replayed in 15e, 16e and 12g, its graph-replayed ms a launch and its bf16
bound.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# kernels hold the plain version to 1e-4 of the largest reference value:
# both are float32 and differ only in summation order (measured ~2e-6 for
# the stem's K = 1344 sums and ~1e-6 for the sparse conv)
KERNEL_TOL = 1e-4
# card (kernels, cuDNN) against CPU (plain versions) through the whole
# model, forward and backward: float32 everywhere, sums in other orders
# through ~20 layers
MODEL_TOL = 1e-4
# gradients that are zero in exact arithmetic (utils/testing.py:
# BN_CANCELLED_BIASES): both sides below this share of their layer's weight
# gradient, as rounding noise
NOISE_TOL = 1e-3
# an NMS word bit may differ between the card and the CPU only where that
# pair's CPU IoU lies this close to the threshold: both clip in float32
# with round-to-nearest, and their sines, cosines and area sums round
# apart by a few ulps of an IoU near 1
NMS_MARGIN = 1e-5
WARMUP, REPEATS = 3, 10
SRC = "multimodal_gar_tpu_torch/csrc"
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (the port
# runs float32 with TF32 off) and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the same data sheet: bf16 on the tensor cores, dense (the bf16 kernels)
PEAK_BF16_FLOPS = 989e12
# phase 15: a bf16 request against the float32 one on the card, of each
# output's largest float32 value (backbone features; a_theta); a tiny bf16
# model card against CPU (bf16 sums in other orders through ~20 layers,
# each rounding to bf16 at 4e-3)
BF16_FEATURE_TOL = 5e-2
BF16_A_THETA_TOL = 2e-2
BF16_MODEL_TOL = 2e-2
DEVICE = "cuda"          # where the phases added for the variants run
# the shipped configs besides mil3 (configs/<name>.yaml)
OTHER_CONFIGS = ("fusion_sum", "fusion_concat", "fusion_cross_attention",
                 "rgb_baseline", "lidar_baseline")


def bound(flop: float, nbytes: float, peak_flops: float = None) -> dict:
    """The least time the card could take for ``flop`` operations (at
    ``peak_flops``, the float32 rate by default) and ``nbytes`` bytes
    moved, in ms, and which of the two sets it."""
    t_ops = flop / (peak_flops or PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Totals:
    """Sums of one kernel's numbers over the shapes it is checked at."""

    def __init__(self, library: bool = False, peak_flops=None):
        self.peak_flops = peak_flops or PEAK_F32_FLOPS
        self.err = self.rel = self.ms = self.call_ms = self.plain_ms = 0.0
        self.flop = self.bytes = self.bound_ms = 0.0
        self.library_ms = 0.0 if library else None
        self.more = {}              # further readings, summed like the rest

    def add_more(self, **readings) -> None:
        for key, value in readings.items():
            self.more[key] = self.more.get(key, 0.0) + value

    def add(self, err, rel, ms, call_ms, plain_ms, bnd, library_ms=None):
        self.err, self.rel = max(self.err, err), max(self.rel, rel)
        self.ms += ms
        self.call_ms += call_ms
        self.plain_ms += plain_ms
        self.flop += bnd["flop"]
        self.bytes += bnd["bytes"]
        self.bound_ms += bnd["bound_ms"]
        if library_ms is not None:
            self.library_ms += library_ms

    def entry(self) -> dict:
        """The kernel's keys of the ``kernels`` line; the bound of a sum of
        calls is the sum of their bounds, set by whichever of operations
        and bytes sets more of it."""
        by_ops = (self.flop / self.peak_flops
                  >= self.bytes / PEAK_BYTES_PER_S)
        return {"max_abs_err": self.err, "max_rel_err": self.rel,
                "ms": self.ms, "per_call_ms": self.call_ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "operations" if by_ops else "bytes",
                "library_ms": self.library_ms, **self.more}


def timed(name: str, fn, *args):
    """``fn(*args)``, with the seconds it took printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase [{name}]: {time.perf_counter() - t0:.1f} s")
    return out


def check(ok, message: str) -> None:
    """Fail the run (independent of python -O)."""
    if not ok:
        raise RuntimeError(message)


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = (got.double() - ref.double()).abs().max().item()
    return err, err / max(ref.double().abs().max().item(), 1e-30)


def kernel_ms(fn) -> tuple:
    """(ms of one launch of ``fn`` within a run of many launches between
    one pair of CUDA events, median ms of a single call between its own
    pair): the first is the kernel's time, the second carries the wrapper's
    host work too."""
    from multimodal_gar_tpu_torch.utils.testing import cuda_ms_per_launch
    return cuda_ms_per_launch(fn), median_ms(fn)


def graph_ms(fn) -> float:
    """ms of one launch of ``fn`` within a run of many launches captured in
    a CUDA graph and replayed between one pair of CUDA events: the device's
    time where a call's host work outlasts its kernel."""
    from multimodal_gar_tpu_torch.utils.testing import (
        cuda_graph_ms_per_launch)
    return cuda_graph_ms_per_launch(fn)


def host_us(fn, calls: int = 1000) -> float:
    """Host-clock microseconds of one ``fn()`` over ``calls`` calls with no
    synchronisation in between."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def median_ms(fn) -> float:
    """Median device time of ``fn`` in ms over REPEATS calls, each between
    its own pair of CUDA events."""
    import torch
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")


def phase_build():
    from multimodal_gar_tpu_torch.ops.kernels import (neighbour_gather,
                                                      nms_bev, row_gather,
                                                      sparse_wgrad, stem_conv,
                                                      subm_conv, window_conv)
    from multimodal_gar_tpu_torch.ops.kernels._build import load_all
    mods = (stem_conv, window_conv, subm_conv, sparse_wgrad, row_gather,
            neighbour_gather, nms_bev)
    t0 = time.perf_counter()
    load_all([mod.LIBRARY for mod in mods])
    print(f"build, {len(mods)} libraries at once: "
          f"{time.perf_counter() - t0:.2f} s")
    for mod in mods:
        lib = mod.LIBRARY
        print(f"build {lib.name}: {lib.build_seconds:.2f} s")
        for line in lib.ptxas_log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {line.strip()}")
    for mod in (stem_conv, window_conv, subm_conv, sparse_wgrad):
        check_wgmma_kernels(mod.LIBRARY)


# the wgmma kernels of each library, by pieces of their mangled names: the
# bf16 stem, the bf16 forward core, kernel C and kernel D's instances at
# D = 64 and its pieces of 64 x 64 past 64 channels
WGMMA_KERNELS = {"stem_conv": ("stem_conv_bf16_kernel",),
                 "window_conv": ("window_conv_bf16_kernel",),
                 "subm_conv": ("subm_conv_wgmma_kernel", "dgrad_bf16_kernel"),
                 "sparse_wgrad": ("wgrad_bf16_kernelILi32ELi64",
                                  "wgrad_bf16_kernelILi64ELi64",
                                  "wgrad_bf16_kernelILi128ELi64",
                                  "wgrad_bf16_kernelILi64ELi128",
                                  "wgrad_bf16_kernelILi128ELi128",
                                  "wgrad_bf16_kernelILi256ELi256")}


def sass_counts(path: str) -> dict:
    """{kernel: {HGMMA, UTMALDG, UBLKCP: count}} from cuobjdump -sass."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HGMMA": 0, "UTMALDG": 0, "UBLKCP": 0}
        elif name is not None:
            for op in counts[name]:
                if f" {op}" in line:
                    counts[name][op] += 1
    return counts


def ptxas_entries(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ptxas -v."""
    import re
    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries[name] = [0, 0, 0]
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                entries[name][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entries[name][0] = int(m.group(1))
    return entries


def check_wgmma_kernels(lib) -> None:
    """Phase 2: the library's wgmma kernels hold HGMMA and TMA loads in
    their SASS and spill nothing."""
    from multimodal_gar_tpu_torch.ops.kernels._build import BUILD_DIR
    path = lib._lib._name if lib._lib is not None else None
    sass = sass_counts(path)
    entries = ptxas_entries(lib.ptxas_log)
    for key in WGMMA_KERNELS[lib.name]:
        counts = {k: v for k, v in sass.items() if key in k}
        check(counts, f"{lib.name}: no {key} in {path} (build dir "
                      f"{BUILD_DIR})")
        for name, c in sorted(counts.items()):
            print(f"  SASS {name[:60]}: HGMMA {c['HGMMA']}, UTMALDG "
                  f"{c['UTMALDG']}, UBLKCP {c['UBLKCP']}")
            check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{name}: a wgmma kernel without HGMMA or TMA loads: {c}")
        mine = {k: v for k, v in entries.items() if key in k}
        check(mine or not lib.build_seconds,
              f"{lib.name}: ptxas printed nothing for {key}")
        for name, (regs, st, ld) in sorted(mine.items()):
            print(f"  ptxas {name[:60]}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B")
            check(st == 0 and ld == 0, f"{name} spills: {st} / {ld} bytes")


def phase_stem(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from multimodal_gar_tpu_torch.models.i3d import s2d_prep
    from multimodal_gar_tpu_torch.ops.kernels.stem_conv import (
        stem_conv, stem_conv_plain)
    dev = "cuda"
    # one mil3 clip and a 7x7x7 stem weight, then the space-to-depth form
    # the model hands the kernel (models/i3d.py: StemUnit3D)
    x3 = torch.randn((1, 15, 720, 1280, 3), device=dev, generator=gen)
    w7 = torch.randn((7, 7, 7, 3, 64), device=dev, generator=gen) * 0.05
    xd, w2 = (t.contiguous() for t in s2d_prep(x3, w7))
    check(tuple(xd.shape) == (1, 15, 363, 643, 12), f"s2d {tuple(xd.shape)}")
    scale = torch.rand(64, device=dev, generator=gen) + 0.5
    bias = torch.randn(64, device=dev, generator=gen) * 0.1
    got = stem_conv(xd, w2, scale, bias)   # holds w2 to the s2d contract
    ref = stem_conv_plain(xd, w2, scale, bias)
    torch.cuda.synchronize()
    check(got.shape == ref.shape == (1, 64, 8, 360, 640),
          f"stem_conv output {tuple(got.shape)}")
    err, rel = rel_err(got, ref)
    ms, call_ms = kernel_ms(lambda: stem_conv(xd, w2, scale, bias,
                                              w2_is_s2d=True))
    plain_ms = median_ms(lambda: stem_conv_plain(xd, w2, scale, bias))
    del ref
    # the library call: F.conv3d alone (no scale, bias or ReLU pass), f32,
    # TF32 off, on the s2d input as the kernel reads it and on the original
    # 3-channel 7x7x7 stride-2 form (TF-SAME pads (3,3), (2,3), (2,3) made
    # outside the timed call, as the s2d form is)
    x_s2d, w_s2d = xd.permute(0, 4, 1, 2, 3), w2.permute(4, 3, 0, 1, 2)
    x_org = F.pad(x3.permute(0, 4, 1, 2, 3), (2, 3, 2, 3, 3, 3)).contiguous()
    w_org = w7.permute(4, 3, 0, 1, 2).contiguous()
    del x3

    def conv_s2d():
        return F.conv3d(x_s2d, w_s2d, stride=(2, 1, 1), padding=(3, 0, 0))

    def conv_org():
        return F.conv3d(x_org, w_org, stride=2)

    affine = (scale.view(1, -1, 1, 1, 1), bias.view(1, -1, 1, 1, 1))
    for name, fn in (("s2d", conv_s2d), ("original", conv_org)):
        _, lib_rel = rel_err(F.relu(fn() * affine[0] + affine[1]), got)
        check(lib_rel <= KERNEL_TOL, f"F.conv3d ({name} form) disagrees with "
              f"the stem kernel: rel err {lib_rel}")
    check(not torch.backends.cudnn.allow_tf32, "TF32 is on for cuDNN")
    s2d_ms, org_ms = median_ms(conv_s2d), median_ms(conv_org)
    # useful work: every output takes the 7*7*7*3 taps of the original
    # kernel (the s2d form's zero tap is no work the function needs)
    bnd = bound(2.0 * got[0, 0].numel() * 64 * 7 * 7 * 7 * 3,
                nbytes(xd, w2, scale, bias, got))
    print(f"stem_conv {tuple(xd.shape)} -> {tuple(got.shape)}: max abs err "
          f"{err:.3e}, rel {rel:.3e}; kernel {ms:.3f} ms (per call "
          f"{call_ms:.3f}), plain {plain_ms:.3f} ms; F.conv3d alone: s2d form {s2d_ms:.3f} ms, original form "
          f"{org_ms:.3f} ms; bound {bnd['bound_ms']:.3f} ms by "
          f"{bnd['bound_by']} ({bnd['flop']:.3e} FLOP, {bnd['bytes']:.3e} B)")
    check(rel <= KERNEL_TOL, f"stem_conv rel err {rel} > {KERNEL_TOL}")
    return {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "per_call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
            "bound_by": bnd["bound_by"], "library_ms": min(s2d_ms, org_ms)}


def phase_window(rulebooks: dict, caps, gen) -> dict:
    """window_conv over the 11 layers on each rulebook of ``rulebooks``
    (name -> dict of numpy maps); the first is the main paths' and gives
    the kernel's entry, the others add ``<name>_*`` keys to it."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
        window_conv, window_conv_plain)
    from multimodal_gar_tpu_torch.utils.testing import (BACKBONE_LAYERS,
                                                        window_taps)
    dev = "cuda"
    entry = {}
    for book, rulebook in rulebooks.items():
        total = Totals()
        rows = taps = 0
        for name, key, _, table_stage, c, d in BACKBONE_LAYERS:
            win = torch.from_numpy(rulebook[key]).to(dev)
            m = caps[table_stage]
            feats = torch.randn((1, m, c), device=dev, generator=gen)
            w = torch.randn((27, c, d), device=dev, generator=gen) \
                / (27 * c) ** .5
            got = window_conv(feats, win, w)
            ref = window_conv_plain(feats, win, w)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            ms, call_ms = kernel_ms(lambda: window_conv(feats, win, w))
            plain_ms = median_ms(lambda: window_conv_plain(feats, win, w))
            present = window_taps(win)
            rows += win.shape[1]
            taps += present
            bnd = bound(2.0 * c * d * present, nbytes(feats, win, w, got))
            print(f"window_conv [{book}] {name}: R {win.shape[1]} M {m} C {c}"
                  f" D {d}, {present} taps: max abs err {err:.3e}, rel "
                  f"{rel:.3e}; kernel {ms:.4f} ms (per call {call_ms:.4f}), "
                  f"plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms "
                  f"by {bnd['bound_by']}")
            check(rel <= KERNEL_TOL, f"window_conv [{book}] {name} rel err "
                  f"{rel}")
            total.add(err, rel, ms, call_ms, plain_ms, bnd)
        print(f"window_conv [{book}], 11 layers, {taps / rows:.2f} taps per "
              f"cap row: kernel {total.ms:.3f} ms (per call "
              f"{total.call_ms:.3f}), plain {total.plain_ms:.3f} ms, bound "
              f"{total.bound_ms:.3f} ms = {total.bound_ms / total.ms:.1%} "
              f"reached ({total.flop:.3e} FLOP over the taps present, "
              f"{total.bytes:.3e} B); no single PyTorch call computes it")
        if not entry:
            entry = total.entry()
        else:
            entry.update({f"{book}_{k}": v for k, v in total.entry().items()
                          if k in ("ms", "per_call_ms", "plain_ms",
                                   "bound_ms", "max_rel_err")})
    return entry


def _time_pair(name, kernel, plain) -> tuple:
    """(max abs err, rel err, kernel ms, kernel ms per single call, plain
    ms) of one kernel call."""
    import torch
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    check(rel <= KERNEL_TOL, f"{name} rel err {rel}")
    return err, rel, *kernel_ms(kernel), median_ms(plain)


def phase_subm_wgrad(fields40, caps40, fields16, clustered16, caps16,
                     gen) -> tuple:
    """K3 as the nbr-map forward (40k rulebook, 11 layers) and as the data
    gradient (16k training rulebook, 10 layers); K4 for the 11 layers of
    the 16k rulebook the train path runs and of a clustered 16k rulebook,
    each layer against the bound of its own present taps. Returns K3's
    totals and K4's entry of the ``kernels`` line."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
        sparse_wgrad, sparse_wgrad_plain)
    from multimodal_gar_tpu_torch.ops.kernels.subm_conv import (
        subm_conv, subm_conv_plain)
    from multimodal_gar_tpu_torch.ops.sparse_maps import backbone_maps
    from multimodal_gar_tpu_torch.utils.testing import BACKBONE_LAYERS
    dev = "cuda"

    def rulebook(fields):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in fields["rulebook"].items()}

    def weights(c, d):
        return torch.randn((27, c, d), device=dev, generator=gen) \
            / (27 * c) ** .5

    k3 = Totals()

    def taps(idx) -> int:
        return int((idx >= 0).sum())

    maps40 = backbone_maps(rulebook(fields40), key_sorted=False,
                           with_bwd=False)
    for name, _, _, table_stage, c, d in BACKBONE_LAYERS:
        key = _map_key(name)
        idx = maps40[key].fwd
        table = torch.randn((1, caps40[table_stage], c), device=dev,
                            generator=gen)
        w = weights(c, d)
        res = _time_pair(f"subm_conv forward {name}",
                         lambda: subm_conv(table, idx, w),
                         lambda: subm_conv_plain(table, idx, w))
        bnd = bound(2.0 * c * d * taps(idx), nbytes(table, idx, w)
                    + idx.shape[1] * d * 4)
        k3.add(*res, bnd)
        print(f"subm_conv forward {name}: R {idx.shape[1]} M {table.shape[1]}"
              f" C {c} D {d}: max abs err {res[0]:.3e}, rel {res[1]:.3e}; "
              f"kernel {res[2]:.4f} ms (per call {res[3]:.4f}), plain {res[4]:.3f} ms; bound "
              f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
    def wgrad_layers(book, maps) -> Totals:
        k4, rows, present = Totals(), 0, 0
        for name, _, _, table_stage, c, d in BACKBONE_LAYERS:
            idx = maps[_map_key(name)].fwd
            table = torch.randn((1, caps16[table_stage], c), device=dev,
                                generator=gen)
            dout = torch.randn((1, idx.shape[1], d), device=dev,
                               generator=gen)
            res = _time_pair(f"sparse_wgrad [{book}] {name}",
                             lambda: sparse_wgrad(table, idx, dout),
                             lambda: sparse_wgrad_plain(table, idx, dout))
            again = sparse_wgrad(table, idx, dout)
            check(torch.equal(again, sparse_wgrad(table, idx, dout)),
                  f"sparse_wgrad [{book}] {name}: two runs differ")
            replay = graph_ms(lambda: sparse_wgrad(table, idx, dout))
            bnd = bound(2.0 * c * d * taps(idx),
                        nbytes(table, idx, dout) + 27 * c * d * 4)
            k4.add(*res, bnd)
            k4.add_more(graph_ms=replay)
            rows += idx.shape[1]
            present += taps(idx)
            print(f"sparse_wgrad [{book}] {name}: R {idx.shape[1]} M "
                  f"{table.shape[1]} C {c} D {d}, {taps(idx)} taps: max abs "
                  f"err {res[0]:.3e}, rel {res[1]:.3e}, twice equal; kernel "
                  f"{res[2]:.4f} ms (per call {res[3]:.4f}, graph replay "
                  f"{replay:.4f}), plain {res[4]:.3f} ms; bound "
                  f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} = "
                  f"{bnd['bound_ms'] / replay:.1%} of the replayed time")
        print(f"sparse_wgrad [{book}], 11 layers, {present / rows:.2f} taps "
              f"per cap row: kernel {k4.ms:.3f} ms (per call "
              f"{k4.call_ms:.3f}, graph replay {k4.more['graph_ms']:.3f}), "
              f"plain {k4.plain_ms:.3f} ms, bound {k4.bound_ms:.3f} ms "
              f"({k4.flop:.3e} FLOP over the taps present, {k4.bytes:.3e} "
              f"B); no single PyTorch call computes it")
        return k4

    maps16 = backbone_maps(rulebook(fields16), key_sorted=True)
    for name, _, _, _, c, d in BACKBONE_LAYERS:
        if name == "conv_input":          # no gradient to the voxel inputs
            continue
        m = maps16[_map_key(name)]
        rows = m.fwd.shape[1]
        dout = torch.randn((1, rows, d), device=dev, generator=gen)
        w = weights(c, d)
        wt = m.dgrad_weights(w)
        res = _time_pair(f"subm_conv dgrad {name}",
                         lambda: subm_conv(dout, m.bwd, wt),
                         lambda: subm_conv_plain(dout, m.bwd, wt))
        bnd = bound(2.0 * c * d * taps(m.bwd), nbytes(dout, m.bwd, wt)
                    + m.bwd.shape[1] * c * 4)
        k3.add(*res, bnd)
        print(f"subm_conv dgrad {name}: R {m.bwd.shape[1]} M {rows} C "
              f"{d} D {c}: max abs err {res[0]:.3e}, rel {res[1]:.3e}; "
              f"kernel {res[2]:.4f} ms (per call {res[3]:.4f}), plain "
              f"{res[4]:.3f} ms; bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']}")
    print(f"subm_conv, 11 forward + 10 dgrad layers: kernel {k3.ms:.3f} "
          f"ms (per call {k3.call_ms:.3f}), plain {k3.plain_ms:.3f} ms, "
          f"bound {k3.bound_ms:.3f} ms ({k3.flop:.3e} FLOP, {k3.bytes:.3e} "
          f"B); no single PyTorch call computes it")
    k4 = wgrad_layers("synthetic", maps16).entry()
    del maps16
    other = wgrad_layers("clustered", backbone_maps(
        rulebook(clustered16), key_sorted=True, with_bwd=False)).entry()
    k4.update({f"clustered_{k}": v for k, v in other.items()
               if k in ("ms", "per_call_ms", "graph_ms", "plain_ms",
                        "bound_ms", "max_rel_err")})
    return k3, k4


def phase_probe_kernels(k3: Totals) -> tuple:
    """The kernels of the gather-probe tool at the tool's own shapes and
    inputs: row_gather (probes A and E) against advanced indexing, exactly,
    beside torch.index_select; window_conv_shifted (probe F) and K3 (probe
    B, added to ``k3``) against their plain versions."""
    import numpy as np
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.row_gather import (
        row_gather, row_gather_plain)
    from multimodal_gar_tpu_torch.ops.kernels.subm_conv import (
        subm_conv, subm_conv_plain)
    from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
        window_conv_shifted, window_conv_shifted_plain)
    from multimodal_gar_tpu_torch.tools import probe_gather as tool
    dev = "cuda"
    gather = Totals(library=True)
    per_shape = []
    rng = np.random.default_rng(0)
    shapes = [(tool.M, tool.C, tool.K3)] + [(m, w, 1)
                                            for m, w in tool.e_shapes()]
    for m, c, k in shapes:
        tab = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32)
                               ).to(dev)
        idx = torch.from_numpy(rng.integers(0, m, (m, k)).astype(np.int32)
                               ).to(dev)
        flat = idx.reshape(-1)
        got, ref = row_gather(tab, idx), row_gather_plain(tab, idx)
        lib = torch.index_select(tab, 0, flat).view(m, k * c)
        torch.cuda.synchronize()
        check(torch.equal(got, ref) and torch.equal(got, lib),
              f"row_gather (M={m}, C={c}, K={k}) is not an exact copy")
        ms, call_ms = kernel_ms(lambda: row_gather(tab, idx))
        plain_ms = median_ms(lambda: row_gather_plain(tab, idx))
        lib_ms = median_ms(lambda: torch.index_select(tab, 0, flat))
        # the device's own time of both: launches replayed from a graph
        replay = graph_ms(lambda: row_gather(tab, idx))
        lib_replay = graph_ms(lambda: torch.index_select(tab, 0, flat))
        bnd = bound(0.0, nbytes(tab, idx, got))
        gather.add(0.0, 0.0, ms, call_ms, plain_ms, bnd, lib_ms)
        gather.add_more(graph_ms=replay, library_graph_ms=lib_replay)
        per_shape.append({"M": m, "C": c, "K": k, "ms": ms,
                          "per_call_ms": call_ms, "graph_ms": replay,
                          "library_ms": lib_ms,
                          "library_graph_ms": lib_replay,
                          "bound_ms": bnd["bound_ms"]})
        print(f"row_gather M {m} C {c} K {k}: equal; kernel {ms:.4f} ms (per "
              f"call {call_ms:.4f}, graph replay {replay:.4f}), advanced "
              f"indexing {plain_ms:.4f} ms, index_select per call "
              f"{lib_ms:.4f} ms (graph replay {lib_replay:.4f}); bound "
              f"{bnd['bound_ms']:.4f} ms by bytes ({bnd['bytes']:.3e} B)")
    print(f"row_gather, probe A + 4 probe E shapes: kernel {gather.ms:.4f} "
          f"ms (per call {gather.call_ms:.4f}, graph replay "
          f"{gather.more['graph_ms']:.4f}), advanced indexing "
          f"{gather.plain_ms:.4f} ms, index_select per call "
          f"{gather.library_ms:.4f} ms (graph replay "
          f"{gather.more['library_graph_ms']:.4f}), bound "
          f"{gather.bound_ms:.4f} ms")
    gather.more["shapes"] = per_shape
    # what any launch costs the device: a 4-element fill, replayed
    four = torch.zeros(4, device=dev)
    print(f"launch floor: a 4-element fill_ replayed from a graph takes "
          f"{graph_ms(lambda: four.fill_(1.0)):.4f} ms per launch")
    _host_split(tab, idx)

    m, c, d = tool.M, tool.C, tool.D
    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.normal(size=(m, 3 * c)).astype(np.float32)
                          ).to(dev)
    pos = torch.from_numpy(rng.integers(0, m, (m, 9)).astype(np.int32)).to(dev)
    sel = torch.from_numpy(rng.integers(0, 64, (m, 9)).astype(np.int32)
                           ).to(dev)
    w = torch.from_numpy(rng.normal(size=(27, c, d)).astype(np.float32) * 0.1
                         ).to(dev)
    res = _time_pair("window_conv_shifted",
                     lambda: window_conv_shifted(wt, pos, sel, w),
                     lambda: window_conv_shifted_plain(wt, pos, sel, w))
    present = sum(int((((sel >> (2 * dx)) & 3) != 3).sum()) for dx in range(3))
    bnd = bound(2.0 * c * d * present, nbytes(wt, pos, sel, w) + m * d * 4)
    shifted = Totals()
    shifted.add(*res, bnd)
    print(f"window_conv_shifted M {m} C {c} D {d}: max abs err {res[0]:.3e}, "
          f"rel {res[1]:.3e}; kernel {res[2]:.4f} ms (per call {res[3]:.4f}), "
          f"plain {res[4]:.4f} ms; "
          f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
          f"({bnd['flop']:.3e} FLOP, {bnd['bytes']:.3e} B); no single "
          f"PyTorch call computes it")

    tab, idx, w = tool.gather_gemm_inputs(m, c, d, 27, dev)
    tab, idx = tab[None], idx[None]
    res = _time_pair("subm_conv at probe B's shape",
                     lambda: subm_conv(tab, idx, w),
                     lambda: subm_conv_plain(tab, idx, w))
    bnd = bound(2.0 * c * d * idx.numel(), nbytes(tab, idx, w) + m * d * 4)
    k3.add(*res, bnd)
    print(f"subm_conv probe B: R {m} M {m} C {c} D {d}: max abs err "
          f"{res[0]:.3e}, rel {res[1]:.3e}; kernel {res[2]:.4f} ms (per call "
          f"{res[3]:.4f}), plain {res[4]:.4f} ms; bound "
          f"{bnd['bound_ms']:.4f} ms by "
          f"{bnd['bound_by']}")
    return gather, shifted


# 3e: the gather backward at a mil3 training micro-step's three scales,
# (M, share of the 47 real boxes' queries kept): x_conv2, x_conv3, x_conv4
NG_SCALES = ((16000, 0.05), (8000, 0.0), (4000, 0.3))


def _ng_inputs(gen, m: int, share: float, c: int = 32) -> tuple:
    """(dout, rows, keep) at one scale: 47 boxes of 216 queries with
    ``share`` of them kept, 53 padded boxes masked with every row on voxel
    17 (an empty query's rows); at the share 0.3 also 350 kept queries on
    voxel 5, a row of 5,600 entries (x_conv4 reaches 5,573)."""
    import torch
    r, s = 21600, 16
    rows = torch.randint(0, m, (1, r, s), device="cuda", generator=gen,
                         dtype=torch.int32)
    keep = torch.rand((1, r), device="cuda", generator=gen) < share
    keep[:, 47 * 216:] = False
    rows[:, 47 * 216:] = 17
    if share >= 0.3:
        keep[:, :350] = True
        rows[:, :350] = 5
    dout = torch.randn((1, r, s, c), device="cuda", generator=gen)
    return dout, rows, keep


def phase_neighbour_gather(gen) -> Totals:
    """3e: the gather backward against its plain version at NG_SCALES."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels import neighbour_gather as ng
    total = Totals(library=True)
    for m, share in NG_SCALES:
        dout, rows, keep = _ng_inputs(gen, m, share)
        c = dout.shape[-1]
        ng.reset_stats("cuda")
        before = ng.neighbour_gather.launches
        got = ng.neighbour_gather_backward(dout, rows, keep, m)
        again = ng.neighbour_gather_backward(dout, rows, keep, m)
        stats = ng.stats("cuda")
        ref = ng.neighbour_gather_backward_plain(dout, rows, keep, m)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        kept = keep[:, :, None].expand(rows.shape)
        counts = torch.bincount(rows[kept].long(), minlength=m)
        check(rel <= KERNEL_TOL and torch.equal(got, again)
              and ng.neighbour_gather.launches == before + 2
              and stats == {"entries": 2 * rows.numel(),
                            "kept": 2 * int(kept.sum()),
                            "longest": int(counts.max())},
              f"neighbour_gather M {m}: rel err {rel}, equal bits "
              f"{torch.equal(got, again)}, stats {stats}")
        flat = rows.long().reshape(-1)
        masked = torch.where(keep[:, :, None, None], dout, 0.0).reshape(-1, c)
        ms, call_ms = kernel_ms(
            lambda: ng.neighbour_gather_backward(dout, rows, keep, m))
        replay = graph_ms(
            lambda: ng.neighbour_gather_backward(dout, rows, keep, m))
        plain_ms = median_ms(
            lambda: ng.neighbour_gather_backward_plain(dout, rows, keep, m))
        lib_ms = median_ms(lambda: torch.zeros((m, c), device="cuda")
                           .index_add_(0, flat, masked))
        n_kept = stats["kept"] // 2
        # kept rows read, dF written, the map's perm and offsets read
        bnd = bound(0.0, n_kept * c * 4 + m * c * 4 + n_kept * 8
                    + (m + 1) * 4)
        total.add(err, rel, ms, call_ms, plain_ms, bnd, lib_ms)
        total.add_more(graph_ms=replay)
        print(f"neighbour_gather M {m} (1, 21600, 16, {c}): kept "
              f"{n_kept} of {rows.numel()} ({n_kept / rows.numel():.1%}), "
              f"longest row {stats['longest']}; max abs err {err:.3e}, rel "
              f"{rel:.3e}, equal bits twice; backward {ms:.4f} ms (per call "
              f"{call_ms:.4f}, graph replay {replay:.4f}), index_put_ "
              f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms; bound "
              f"{bnd['bound_ms']:.4f} ms by bytes ({bnd['bytes']:.3e} B)")
    return total


# 3f: (what, boxes, kind, threshold, nms or circle_nms) at the main paths'
# sizes: Voxel R-CNN's training proposal NMS (9000 -> 512 at 0.8), SECOND's
# and CenterPoint's test-time NMS over 1024 and 500 boxes at 0.7, and
# circle_nms (the sweep alone) at 500
NMS_CASES = (("voxelrcnn train, clustered", 9000, "clustered", 0.8, "bev"),
             ("voxelrcnn train, anchor grid", 9000, "anchors", 0.8, "bev"),
             ("SECOND test", 1024, "anchors", 0.7, "bev"),
             ("CenterPoint test", 500, "clustered", 0.7, "bev"),
             ("circle_nms", 500, "clustered", 2.0, "circle"))
# least operations of a clip, as h100_bench/counts/voxelrcnn.py counts them:
# 4 edges x 4 vertices x 4 for the side tests, for each truly overlapping
# pair
NMS_FLOP_PER_OVERLAP = 64


def _nms_boxes(g, n: int, kind: str) -> tuple:
    """(boxes (n, 7), scores, valid) on the host: ``clustered`` about 40
    cars as a trained RPN's are; ``anchors`` KITTI's Car anchors (3.9 x
    1.6 x 1.56 at 0 and pi / 2 on the 176 x 200 grid of 0.4 m) nudged by
    a few cm, as the RPN's proposals at the start of training, where
    neighbouring anchors overlap at IoU 0.81 and so straddle 0.8."""
    import torch
    size = torch.tensor([3.9, 1.6, 1.56])
    if kind == "clustered":
        cars = torch.cat([torch.rand(40, 1, generator=g) * 70,
                          torch.rand(40, 1, generator=g) * 80 - 40], 1)
        pick = torch.randint(0, 40, (n,), generator=g)
        xy = cars[pick] + 0.4 * torch.randn(n, 2, generator=g)
        dims = size * (1 + 0.08 * torch.randn(n, 3, generator=g))
        yaw = (torch.randint(0, 2, (n, 1), generator=g) * 1.57
               + 0.1 * torch.randn(n, 1, generator=g))
    else:
        cell = torch.randperm(176 * 200 * 2, generator=g)[:n]
        ix, iy, rot = cell % 176, (cell // 176) % 200, cell // (176 * 200)
        xy = torch.stack([(ix + 0.5) * 0.4, (iy + 0.5) * 0.4 - 40], 1) \
            + 0.03 * torch.randn(n, 2, generator=g)
        dims = size * (1 + 0.01 * torch.randn(n, 3, generator=g))
        yaw = (rot[:, None] * 1.57 + 0.01 * torch.randn(n, 1, generator=g))
    boxes = torch.cat([xy, -1.0 + 0.1 * torch.randn(n, 1, generator=g),
                       dims, yaw], 1).float()
    return (boxes, torch.rand(n, generator=g),
            torch.rand(n, generator=g) > 0.02)


def _bits_near_threshold(words, ref_words, boxes, thr: float) -> int:
    """The number of word bits that differ between ``words`` and
    ``ref_words`` (host), each checked to be a pair of ``boxes`` (sorted,
    host) whose CPU IoU lies within NMS_MARGIN of ``thr``."""
    from multimodal_gar_tpu_torch.ops import boxes3d as b3
    diff = (words ^ ref_words).nonzero().tolist()
    n_bits = 0
    for i, w in diff:
        x = int(words[i, w] ^ ref_words[i, w])
        for bit in range(64):
            if (x >> bit) & 1:
                j = 64 * w + bit
                iou = float(b3.boxes_iou_bev(boxes[j:j + 1], boxes[i:i + 1]))
                check(abs(iou - thr) < NMS_MARGIN, f"NMS word bit ({i}, {j})"
                      f": IoU {iou} is not within {NMS_MARGIN} of {thr}")
                n_bits += 1
    return n_bits


def _host_clock_ms(fn, calls: int = 3) -> float:
    """Median host-clock ms of ``fn()`` to the device's end over ``calls``
    calls after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_nms() -> Totals:
    """3f: the NMS kernels against their plain versions at NMS_CASES."""
    import torch
    from multimodal_gar_tpu_torch.ops import boxes3d as b3
    from multimodal_gar_tpu_torch.ops.kernels import nms_bev as nw
    total = Totals()
    g = torch.Generator().manual_seed(22)
    for what, n, kind, thr, nms in NMS_CASES:
        boxes, scores, valid = _nms_boxes(g, n, kind)
        order = torch.argsort(-scores, stable=True)
        sorted_boxes = boxes[order]
        cb, cv = sorted_boxes.cuda(), valid[order].cuda()
        if nms == "bev":
            ref_words, ref_counts = nw.bev_words(sorted_boxes, thr)
            words, counts = nw.bev_words(cb, thr)
            words2, _ = nw.bev_words(cb, thr)
            host_words = words.cpu()
            n_bits = _bits_near_threshold(host_words, ref_words,
                                          sorted_boxes, thr)
            check(torch.equal(words, words2), f"3f {what}: the words differ "
                  f"between two runs")
            overlaps = int(counts[1])
            check(abs(int(counts[0]) - int(ref_counts[0]))
                  <= 0.001 * int(ref_counts[0]) and overlaps > 0,
                  f"3f {what}: clipped pairs {counts.tolist()} on the card, "
                  f"{ref_counts.tolist()} on the CPU")
        else:
            # circle_nms packs its words with torch; the sweep is the kernel
            centers = sorted_boxes[:, :2]
            later = torch.arange(n)
            ref_words = torch.cat([nw.pack_words(
                (((centers[None] - centers[s:s + 64, None]) ** 2).sum(-1)
                 <= thr) & (later[None] > later[s:s + 64, None]))
                for s in range(0, n, 64)])
            words, host_words, n_bits, overlaps = \
                ref_words.cuda(), ref_words, 0, 0
        keep = nw.sweep(words, cv)
        keep2 = nw.sweep(words, cv)
        ref_keep = nw.sweep_plain(ref_words, valid[order])
        check(torch.equal(keep, keep2), f"3f {what}: the keep masks differ "
              f"between two runs")
        check(torch.equal(keep.cpu(), nw.sweep_plain(host_words,
                                                     valid[order])),
              f"3f {what}: the sweep kernel differs from the plain sweep of "
              f"the same words")
        same_keep = torch.equal(keep.cpu(), ref_keep)
        check(same_keep or n_bits > 0, f"3f {what}: the keep masks differ "
              f"with equal words")
        if nms == "bev" and n == 9000 and kind == "clustered":
            args = (boxes.cuda(), scores.cuda(), thr, valid.cuda())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            b3.nms_bev(*args)
            torch.cuda.synchronize()
            own = torch.cuda.max_memory_allocated() - base
            check(own < 64 * 2 ** 20, f"3f {what}: nms_bev allocated {own} "
                  f"bytes of its own")
            print(f"3f {what}: nms_bev allocates {own / 2 ** 20:.2f} MiB of "
                  f"its own")
        calls = []
        if nms == "bev":
            calls.append(("words", lambda: nw.bev_words(cb, thr)))
        calls.append(("sweep", lambda: nw.sweep(words, cv)))
        ms = call_ms = replay = 0.0
        parts = {}
        for name, fn in calls:
            k_ms, c_ms = kernel_ms(fn)
            g_ms = graph_ms(fn)
            ms, call_ms, replay = ms + k_ms, call_ms + c_ms, replay + g_ms
            parts[f"{name}_ms"] = k_ms
            parts[f"{name}_graph_ms"] = g_ms
        # the plain words synchronise in every block of rows: the host's
        # clock over a few calls
        plain_words_ms = _host_clock_ms(
            lambda: nw.bev_words_plain(cb, thr)) if nms == "bev" else 0.0
        plain_sweep_ms = _host_clock_ms(
            lambda: nw.sweep_plain(host_words, valid[order]))
        nwords = nw.num_words(n)
        # the upper triangle of the words, written once and read once by
        # the sweep, the boxes read, the valid flags read and the mask
        # written
        upper = sum(nwords - i // 64 for i in range(n)) * 8
        nbytes_least = upper * (2 if nms == "bev" else 1) \
            + (n * 7 * 4 if nms == "bev" else 0) + 2 * n
        bnd = bound(NMS_FLOP_PER_OVERLAP * overlaps, nbytes_least)
        total.add(0.0, 0.0, ms, call_ms, plain_words_ms + plain_sweep_ms,
                  bnd)
        total.add_more(graph_ms=replay, **parts)
        print(f"3f {what} ({n} boxes at {thr}, {nms}): kept "
              f"{int(keep.sum())} of {int(valid.sum())} valid, {n_bits} word "
              f"bits within {NMS_MARGIN} of the threshold differ from the "
              f"CPU's, keep masks {'equal' if same_keep else 'differ'}, "
              f"equal bits twice; clipped / overlapping pairs "
              f"{counts.tolist() if nms == 'bev' else '-'}; kernels "
              f"{ms:.4f} ms (per call {call_ms:.4f}, graph replay "
              f"{replay:.4f}; "
              f"{', '.join(f'{k} {v:.4f}' for k, v in parts.items())}), "
              f"plain words on the card {plain_words_ms:.2f} ms, plain sweep "
              f"on the host {plain_sweep_ms:.2f} ms; bound "
              f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
    return total


def _host_split(tab, idx) -> None:
    """What one row_gather call costs the host, piece by piece, beside
    torch.index_select: host clock over 1,000 calls each, nothing
    synchronised in between."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels import row_gather as mod
    from multimodal_gar_tpu_torch.ops.kernels._build import stream_handle
    (m, c), rows = tab.shape, idx.numel()
    flat = idx.reshape(-1)
    lib = mod.LIBRARY.load()
    out = tab.new_empty((rows, c))
    args = (tab.data_ptr(), idx.data_ptr(), out.data_ptr(), m, c, rows,
            stream_handle(tab.device))
    split = {
        "row_gather": lambda: mod.row_gather(tab, idx),
        "index_select": lambda: torch.index_select(tab, 0, flat),
        "checks": lambda: (mod._check(tab, idx), mod._check_kernel(tab, idx)),
        "allocation": lambda: tab.new_empty((rows, c)),
        "stream handle": lambda: stream_handle(tab.device),
        "a torch.cuda.Stream object instead":
            lambda: torch.cuda.current_stream(tab.device).cuda_stream,
        "three data_ptr": lambda: (tab.data_ptr(), idx.data_ptr(),
                                   out.data_ptr()),
        "ctypes call with the launch": lambda: lib.mgar_row_gather_f32(*args),
        "an empty call": lambda: None,
    }
    print(f"host microseconds per call at M {m} C {c} K {idx.shape[1]}: "
          + ", ".join(f"{k} {host_us(fn):.2f}" for k, fn in split.items()))


def _map_key(layer: str) -> str:
    """The rulebook's explicit map of a VoxelBackbone8x layer."""
    from multimodal_gar_tpu_torch.utils.testing import BACKBONE_LAYERS
    for name, win, stage, _, _, _ in BACKBONE_LAYERS:
        if name == layer:
            return f"down_{stage}" if win.startswith("dwin") \
                else f"nbr_{stage}"
    raise KeyError(layer)


def _outputs(out):
    """(name, tensor) of every float output field the modality gives."""
    for name in ("a_theta", "card", "rgb_features", "lidar_features",
                 "fused_features"):
        if getattr(out, name) is not None:
            yield name, getattr(out, name)
    for name in ("pose", "interaction", "sg_pose", "sg_interaction"):
        for i, t in enumerate(getattr(out, name)):
            yield f"{name}[{i}]", t


def _model(cfg, device):
    import torch
    from multimodal_gar_tpu_torch.models import MGAR
    from multimodal_gar_tpu_torch.utils.testing import randomize_
    model = MGAR(cfg, device=device,
                 generator=torch.Generator().manual_seed(0))
    randomize_(model, torch.Generator().manual_seed(1))
    return model


def _card_vs_cpu(cfg, fields, what: str) -> tuple:
    """The eval forward of ``cfg``'s model on the card (kernels, cuDNN) and
    on the CPU (plain versions), same seeded weights and batch: (worst rel
    err over the float outputs, their number); group ids must be equal."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import batch_from_numpy
    ref = make_eval_step(_model(cfg, "cpu"))(batch_from_numpy(fields))
    got = make_eval_step(_model(cfg, DEVICE))(
        batch_from_numpy(fields, DEVICE)).to("cpu")
    refs = dict(_outputs(ref))
    worst = 0.0
    for name, t in _outputs(got):
        _, rel = rel_err(t, refs[name])
        check(rel <= MODEL_TOL, f"{what} {name}: rel err {rel}")
        worst = max(worst, rel)
    check(torch.equal(got.group_ids, ref.group_ids),
          f"{what}: group_ids differ")
    return worst, len(refs)


def phase_tiny():
    from multimodal_gar_tpu_torch.utils.testing import (
        synthetic_batch_numpy, tiny_config)
    cfg = tiny_config()
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    worst, n = _card_vs_cpu(cfg, fields, "tiny forward")
    print(f"tiny_config forward, card vs CPU: max rel err {worst:.3e} over "
          f"{n} outputs, group_ids equal")


def _shipped_configs(base, with_mil3: bool = False) -> list:
    """(name, config) of the shipped configs/*.yaml over ``base``."""
    from multimodal_gar_tpu_torch.utils.testing import with_model_of
    names = (("mil3",) if with_mil3 else ()) + OTHER_CONFIGS
    here = os.path.dirname(os.path.abspath(__file__))
    return [(name, with_model_of(os.path.join(here, "configs",
                                              f"{name}.yaml"), base))
            for name in names]


def phase_variants():
    """Every configuration beyond mil3's, eval forward card vs CPU at
    tiny_config."""
    from multimodal_gar_tpu_torch.utils.testing import (
        MODEL_VARIANTS, synthetic_batch_numpy, tiny_config, with_model)
    base = tiny_config()
    fields = synthetic_batch_numpy(base, batch_size=2, seed=0)
    cases = [(f"configs/{name}.yaml", cfg)
             for name, cfg in _shipped_configs(base)]
    cases += [(name, with_model(base, **change))
              for name, change in MODEL_VARIANTS]
    check(len(cases) == 36, f"{len(cases)} variants, expected 36")
    worst_of_all = 0.0
    for name, cfg in cases:
        worst, n = _card_vs_cpu(cfg, fields, name)
        worst_of_all = max(worst_of_all, worst)
        print(f"variant [{name}], card vs CPU: max rel err {worst:.3e} over "
              f"{n} outputs, group_ids equal")
    print(f"{len(cases)} variants at tiny_config, card vs CPU: max rel err "
          f"{worst_of_all:.3e} (limit {MODEL_TOL:g}), group_ids equal in "
          f"each")


def _tiny_train_card_vs_cpu(cfg, fields, what: str) -> str:
    """One train step's forward and backward of ``cfg``'s model, card
    against CPU (same weights and conditioned batch, dropout off): loss,
    every parameter gradient and the new BatchNorm statistics to
    MODEL_TOL; the gradients that are zero in exact arithmetic only as
    rounding noise. Returns the line that reports it."""
    import torch
    from multimodal_gar_tpu_torch.utils.testing import (
        BN_CANCELLED_BIASES, batch_from_numpy, condition_for_grad_parity_,
        prepare_grad_parity_, train_loss_and_grads)
    fields = condition_for_grad_parity_(dict(fields))
    runs = {}
    for dev in ("cpu", DEVICE):
        model = prepare_grad_parity_(_model(cfg, dev))
        loss, grads, stats = train_loss_and_grads(
            model, batch_from_numpy(fields, dev))
        runs[dev] = (loss.cpu(), {k: v.cpu() for k, v in grads.items()},
                     {k: v.cpu() for k, v in stats.items()})
    (ref_loss, ref_g, ref_s), (loss, grads, stats) = runs["cpu"], runs[DEVICE]
    _, rel = rel_err(loss, ref_loss)
    check(rel <= MODEL_TOL, f"{what} loss rel err {rel}")
    worst_g = worst_s = 0.0
    for k, g in grads.items():
        if k in BN_CANCELLED_BIASES:
            scale = ref_g[k.replace(".bias", ".weight")].abs().max().item()
            for side in (g, ref_g[k]):
                check(side.abs().max().item() <= NOISE_TOL * scale,
                      f"{what} gradient {k} is not rounding noise")
            continue
        _, r = rel_err(g, ref_g[k])
        check(r <= MODEL_TOL, f"{what} gradient {k}: rel err {r}")
        worst_g = max(worst_g, r)
    for k, v in stats.items():
        _, r = rel_err(v, ref_s[k])
        check(r <= MODEL_TOL, f"{what} statistic {k}: rel err {r}")
        worst_s = max(worst_s, r)
    check(torch.count_nonzero(grads[
        "lidar_backbone.backbone3d.conv_input.conv.weight"]) > 0,
        "the sparse conv weights got no gradient")
    return (f"{what}, card vs CPU: loss {loss.item():.6f} rel err "
            f"{rel:.3e}; {len(grads)} gradients max rel err {worst_g:.3e};"
            f" {len(stats)} BN statistics max rel err {worst_s:.3e}")


def phase_tiny_train():
    """One train step's forward and backward, card against CPU."""
    from multimodal_gar_tpu_torch.utils.testing import (
        synthetic_batch_numpy, tiny_config)
    cfg = tiny_config()
    print(_tiny_train_card_vs_cpu(
        cfg, synthetic_batch_numpy(cfg, batch_size=2, seed=0),
        "tiny_config train step"))


def check_outputs(out, valid) -> None:
    """Finite, masked, eval-diagonal and softmax invariants of one output."""
    import torch
    invalid = ~valid
    for name, t in _outputs(out):
        check(torch.isfinite(t).all(), f"{name} not finite")
    a = out.a_theta
    diag = torch.diagonal(a, dim1=1, dim2=2)
    check(torch.all(diag[valid] == 1), "a_theta diagonal != 1")
    check(torch.all(a[invalid] == 0)
          and torch.all(a.transpose(1, 2)[invalid] == 0),
          "padded a_theta rows not zero")
    for name, t in _outputs(out):
        if name not in ("a_theta", "card"):
            check(torch.all(t[invalid] == 0), f"padded {name} rows not zero")
    for p in out.pose:
        check(torch.allclose(p[valid].sum(-1),
                             torch.ones_like(p[valid][:, 0])),
              "pose rows do not sum to 1")


def _counters():
    from multimodal_gar_tpu_torch.ops.kernels import (neighbour_gather,
                                                      nms_bev, row_gather,
                                                      sparse_wgrad, stem_conv,
                                                      subm_conv, window_conv)
    return {"stem_conv": stem_conv.stem_conv,
            "window_conv": window_conv.window_conv,
            "subm_conv": subm_conv.subm_conv,
            "sparse_wgrad": sparse_wgrad.sparse_wgrad,
            "row_gather": row_gather.row_gather,
            "window_conv_shifted": window_conv.window_conv_shifted,
            "stem_conv_bf16": stem_conv.stem_conv_bf16,
            "window_conv_bf16": window_conv.window_conv_bf16,
            "subm_conv_bf16": subm_conv.subm_conv_bf16,
            "subm_conv_dgrad_bf16": subm_conv.subm_conv_dgrad_bf16,
            "sparse_wgrad_bf16": sparse_wgrad.sparse_wgrad_bf16,
            "neighbour_gather": neighbour_gather.neighbour_gather,
            "nms_bev_words": nms_bev.bev_words,
            "nms_sweep": nms_bev.sweep}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def phase_full(fields):
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config)
    cfg = flagship_config()
    batch = batch_from_numpy(fields, "cuda")
    eval_step = make_eval_step(_model(cfg, "cuda"))
    eval_step(batch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times = []
    for i in range(3):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ran = {k: v - before[k] for k, v in _counts().items()}
        check(ran["stem_conv"] == 1, "stem kernel launches != 1")
        check(ran["window_conv"] == 11, "window_conv launches != 11")
        check_outputs(out, batch.person_valid)
        print(f"request {i}: {times[-1]:.2f} ms, stem launches "
              f"{ran['stem_conv']}, window_conv launches "
              f"{ran['window_conv']}, outputs finite and masked")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"full width (1 x 15 x 720 x 1280, 100 actors, 40k voxels): "
          f"per-request ms {[round(t, 2) for t in times]}, peak device "
          f"memory {peak:.2f} GiB")
    check(launches["stem_conv"] > 0 and launches["window_conv"] > 0,
          f"a kernel of the path never launched: {launches}")
    return launches, out


def phase_full_nbr(fields, xw_out) -> dict:
    """3 full-width eval requests on the nbr-map path, held to the x-window
    path's outputs (xw_out, the same batch and weights)."""
    import dataclasses
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config)
    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lidar=dataclasses.replace(cfg.model.lidar,
                                             x_window=False)))
    batch = batch_from_numpy(fields, "cuda")
    eval_step = make_eval_step(_model(cfg, "cuda"))
    eval_step(batch)                                   # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    refs = dict(_outputs(xw_out))
    for i in range(3):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        now = _counts()
        check(now["subm_conv"] - before["subm_conv"] == 11,
              "subm_conv launches != 11 on the nbr-map path")
        check(now["window_conv"] == before["window_conv"],
              "window_conv launched on the nbr-map path")
        check(now["stem_conv"] - before["stem_conv"] == 1,
              "stem kernel launches != 1")
        check_outputs(out, batch.person_valid)
        worst = 0.0
        for name, t in _outputs(out):
            _, rel = rel_err(t, refs[name])
            check(rel <= MODEL_TOL, f"nbr-map {name} vs x-window: rel err "
                  f"{rel}")
            worst = max(worst, rel)
        check(torch.equal(out.group_ids, xw_out.group_ids),
              "nbr-map group_ids differ from the x-window path's")
        print(f"nbr-map request {i}: {times[-1]:.2f} ms, subm_conv launches "
              f"11, window_conv 0; outputs vs x-window max rel err "
              f"{worst:.3e}, group_ids equal")
    return _counts()


def phase_train(fields) -> dict:
    """16 full-width micro-steps at the 16k training cap, accumulation 8."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import (make_optimizer,
                                                            make_train_step)
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config,
                                                        people_on_voxels)
    cfg = flagship_config(max_voxels=16000)
    accum = cfg.train.grad_accum_steps
    check(accum == 8, f"mil3 accumulates 8 steps, config says {accum}")
    batch = batch_from_numpy(people_on_voxels(fields, cfg), "cuda")
    model = _model(cfg, "cuda")
    opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                         steps_per_epoch=64, grad_accum=accum,
                         gamma=cfg.train.lr_decay_gamma)
    step = make_train_step(model, opt, "L_total")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    per_step = {"stem_conv": 1, "window_conv": 11, "subm_conv": 10,
                "sparse_wgrad": 11,
                "neighbour_gather": len(cfg.model.lidar.pool_layers),
                "nms_bev_words": 0, "nms_sweep": 0}
    times = []
    prev = [p.detach().clone() for p in opt.params]
    for i in range(1, 2 * accum + 1):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        now = _counts()
        for k, n in per_step.items():
            check(now[k] - before[k] == n, f"micro-step {i}: {k} launches "
                  f"{now[k] - before[k]} != {n}")
        loss = metrics["loss"].item()
        check(math.isfinite(loss), f"micro-step {i}: loss {loss}")
        check(metrics["nonfinite_grads"].item() == 0.0,
              f"micro-step {i}: non-finite gradients")
        moved = [not torch.equal(p, q) for p, q in zip(opt.params, prev)]
        if i % accum:
            check(not any(moved), f"micro-step {i}: {sum(moved)} parameters "
                  f"moved before the accumulation completed")
        else:
            # Adam moves exactly the tensors whose mean gradient so far is
            # not zero (with random weights some heads saturate past the
            # BCE clip, and L_total leaves card_net out: zero gradients)
            m1 = [opt.adam.state[p]["exp_avg"].abs().max().item()
                  for p in opt.params]
            check(all(m > 0 for m, mv in zip(m1, moved) if mv)
                  and all(mv for m, mv in zip(m1, moved) if m > 1e-12)
                  and any(moved), f"micro-step {i}: {sum(moved)} "
                  f"parameters moved, {sum(m > 0 for m in m1)} had a "
                  f"gradient")
            still = [n for (n, p), m in zip(
                ((n, p) for n, p in model.named_parameters()
                 if p.requires_grad), m1) if m == 0]
            sparse = [j for j, (n, p) in enumerate(
                (n, p) for n, p in model.named_parameters()
                if p.requires_grad) if ".backbone3d." in n
                and n.endswith("conv.weight")]
            check(len(sparse) == 11 and all(moved[j] for j in sparse),
                  f"micro-step {i}: a sparse conv weight did not move")
            print(f"update {opt.updates}: {sum(moved)} of {len(moved)} "
                  f"parameter tensors moved; zero gradient: {still[:12]}"
                  f"{' ...' if len(still) > 12 else ''}")
        prev = [p.detach().clone() for p in opt.params]
        print(f"train micro-step {i}: {times[-1]:.2f} ms, loss {loss:.6f}, "
              f"parameters moved {sum(moved)}, launches "
              f"{ {k: now[k] - before[k] for k in per_step} }")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"full-width train (1 x 15 x 720 x 1280, 100 actors, 16k voxels, "
          f"accumulation {accum}): median micro-step "
          f"{statistics.median(times):.2f} ms (steps 2-16: "
          f"{statistics.median(times[1:]):.2f} ms), {opt.updates} updates, "
          f"peak device memory {peak:.2f} GiB")
    check(opt.updates == 2, f"{opt.updates} optimizer updates, expected 2")
    return launches


def _expected_launches(cfg, train: bool) -> dict:
    """Kernel launches of one eval request / one train micro-step: the
    grid pool's gather backward once a scale; MGAR runs no NMS."""
    modality = cfg.model.fusion.modality
    rgb, lidar = modality != "LiDAR", modality != "RGB"
    return {"stem_conv": int(rgb), "window_conv": 11 * lidar,
            "subm_conv": 10 * lidar * train, "sparse_wgrad": 11 * lidar * train,
            "neighbour_gather": len(cfg.model.lidar.pool_layers) * lidar
            * train, "nms_bev_words": 0, "nms_sweep": 0}


def phase_configs(fields40, fields16) -> tuple:
    """mil3 and the five other shipped configs at full width: 3 eval
    requests at the 40k cap and 2 train micro-steps at the 16k cap each,
    checked, then both timed by CUDA events (mil3 is the yardstick of the
    line printed per config). Returns the phase's launch counts (warm-ups
    and timed runs included: they are the same path) and mil3's micro-step
    device seconds."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import (
        make_eval_step, make_optimizer, make_train_step)
    from multimodal_gar_tpu_torch.utils.profiling import time_fn
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config,
                                                        people_on_voxels)
    base = flagship_config()
    batch40 = batch_from_numpy(fields40, DEVICE)
    batch16 = batch_from_numpy(
        people_on_voxels(fields16, flagship_config(max_voxels=16000)), DEVICE)
    _reset_counts()
    mil3 = {}
    for name, cfg in _shipped_configs(base, with_mil3=True):
        model = _model(cfg, DEVICE)              # weights do not depend on
        eval_step = make_eval_step(model)        # the voxel caps
        eval_step(batch40)                                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        host_ms = []
        want = _expected_launches(cfg, train=False)
        for i in range(3):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eval_step(batch40)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ran = {k: _counts()[k] - before[k] for k in want}
            check(ran == want, f"{name} request {i}: launches {ran}, "
                  f"expected {want}")
            check_outputs(out, batch40.person_valid)
        eval_s, _ = time_fn(eval_step, batch40, iters=5, warmup=1)
        eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del out

        opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                             steps_per_epoch=64, grad_accum=2,
                             gamma=cfg.train.lr_decay_gamma)
        step = make_train_step(model, opt, "L_total")
        step(batch16)                                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        want_t = _expected_launches(cfg, train=True)
        for i in range(2):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch16)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            ran = {k: _counts()[k] - before[k] for k in want_t}
            check(ran == want_t, f"{name} micro-step {i}: launches {ran}, "
                  f"expected {want_t}")
            loss = metrics["loss"].item()
            check(math.isfinite(loss)
                  and metrics["nonfinite_grads"].item() == 0.0,
                  f"{name} micro-step {i}: loss {loss}, non-finite gradients "
                  f"{metrics['nonfinite_grads'].item()}")
        step_s, _ = time_fn(step, batch16, iters=4, warmup=0)
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if name == "mil3":
            mil3 = {"eval_s": eval_s, "step_s": step_s}
        print(f"config [{name}] full width: request {eval_s * 1e3:.2f} ms by "
              f"CUDA events = {eval_s / mil3['eval_s']:.3f} of mil3's (host "
              f"clock {[round(t, 2) for t in host_ms]}), launches per "
              f"request {want}, peak {eval_peak:.2f} GiB; train micro-step "
              f"{step_s * 1e3:.2f} ms by CUDA events = "
              f"{step_s / mil3['step_s']:.3f} of mil3's (host clock "
              f"{[round(t, 2) for t in step_ms]}), launches per micro-step "
              f"{want_t}, loss {loss:.6f}, peak {train_peak:.2f} GiB")
        del model, opt, step, eval_step
        torch.cuda.empty_cache()
    return _counts(), mil3["step_s"]


def phase_probe_tool() -> dict:
    """The gather-probe tool's entry point at its default sizes."""
    from multimodal_gar_tpu_torch.tools import probe_gather
    _reset_counts()
    t0 = time.perf_counter()
    rc = probe_gather.main(["--device", "cuda"])
    check(rc == 0, f"probe_gather.main returned {rc}")
    counts = _counts()
    print(f"probe tool: {time.perf_counter() - t0:.1f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for k in ("row_gather", "window_conv_shifted", "subm_conv",
              "window_conv"):
        check(counts[k] > 0, f"the probe tool never launched {k}")
    return counts


def _end_state(state) -> dict:
    """Clones of everything a run ends with: weights, BatchNorm statistics,
    Adam moments, the accumulator, the counts."""
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def _state_difference(got: dict, ref: dict) -> tuple:
    """(tensors that are not bit-equal, the worst |got - ref| over the
    largest |ref| of its tensor) over the model's and the optimizer's
    tensors of two ``_end_state``s; the counts must be equal."""
    import torch
    check(got["step"] == ref["step"]
          and got["optimizer"]["updates"] == ref["optimizer"]["updates"]
          and got["optimizer"]["mini_step"] == ref["optimizer"]["mini_step"],
          "two runs ended at different steps")
    pairs = [(k, got["model"][k], v) for k, v in ref["model"].items()]
    for key in ("exp_avg", "exp_avg_sq", "acc"):
        pairs += [(f"{key}[{n}]", a, b) for n, (a, b) in enumerate(
            zip(got["optimizer"][key], ref["optimizer"][key]))]
    unequal, worst = [], 0.0
    for name, a, b in pairs:
        if not torch.equal(a, b):
            unequal.append(name)
            worst = max(worst, rel_err(a.float(), b.float())[1])
    return unequal, worst


def _check_same_end(what: str, got: dict, ref: dict) -> None:
    unequal, worst = _state_difference(got, ref)
    n = len(ref["model"]) + 3 * len(ref["optimizer"]["acc"])
    print(f"{what}: {n - len(unequal)} of {n} tensors bit for bit equal"
          + (f"; worst relative difference {worst:.3e} in {unequal[:6]}"
             if unequal else ""))
    check(not unequal, f"{what}: {len(unequal)} tensors differ, worst "
          f"relative difference {worst:.3e}: {unequal[:12]}")


def _host_pool_timings(sample: dict, train_ds, n_train: int) -> None:
    """What the decode pool costs on the host, nothing running on the card:
    ``sample`` (one 40k clip) through the pool's transport, and the
    pipeline alone over ``train_ds`` with and without decode processes."""
    # what a decode worker's result costs on its way to the parent: the last
    # sample through the pool's transport (a pickled message in a
    # SimpleQueue's pipe) from a forked child that only sends it, as it is
    # and with raw uint8 frames (data.images_uint8)
    import multiprocessing
    import numpy as np
    ctx = multiprocessing.get_context("fork")
    pipe_q = ctx.SimpleQueue()
    raw = dict(sample, images=sample["images"].astype(np.uint8))
    messages = (sample, sample, raw)
    child = ctx.Process(target=lambda: [pipe_q.put(m) for m in messages],
                        daemon=True)
    child.start()
    for _ in messages:
        t0 = time.perf_counter()
        got = pipe_q.get()
        t_get = time.perf_counter() - t0
        mb = sum(a.nbytes for v in got.values()
                 for a in (v.values() if isinstance(v, dict) else [v])
                 if hasattr(a, "nbytes")) / 1e6
        print(f"host, one 40k sample ({mb:.1f} MB, frames "
              f"{got['images'].dtype}) from a forked child through a "
              f"SimpleQueue: {t_get:.3f} s")
    child.join(timeout=10)
    check(child.exitcode == 0, f"the sending child ended {child.exitcode}")
    del got, raw, messages

    # the pipeline alone, nothing running on the card: what the host can
    # deliver with and without decode processes, and when each batch came
    from multimodal_gar_tpu_torch.data.pipeline import DataPipeline
    print(f"host: {len(os.sched_getaffinity(0))} cores for this process")
    for workers in (0, 4):
        pipe = DataPipeline(train_ds, 1, shuffle=False, num_workers=workers)
        t0 = time.perf_counter()
        arrivals = [round(time.perf_counter() - t0, 2)
                    for _ in pipe.epoch(0)]
        pipe.close()
        check(len(arrivals) == n_train, f"pipeline alone: {len(arrivals)} "
              f"batches of {n_train}")
        print(f"host, the pipeline alone, num_workers {workers}: "
              f"{n_train / arrivals[-1]:.3f} clips/s, batches arrived at "
              f"{arrivals} s")


def phase_cli(step_device_s: float, sweep: bool = False) -> dict:
    """run_training without decode workers, one epoch with 4, a cut and
    resumed run, run_eval, resume, and a run with an I3D checkpoint, at full
    width on in-memory synthetic clips. ``step_device_s``: mil3's train micro-step
    by CUDA events (phase 6b), the device's own pace for these clips.
    ``sweep``: also time the pool's transport and the pipeline alone, and
    run with 8 workers."""
    import torch
    from multimodal_gar_tpu_torch.config import StageConfig
    from multimodal_gar_tpu_torch.data.rulebook import build_rulebook
    from multimodal_gar_tpu_torch.train.loop import run_eval, run_training
    from multimodal_gar_tpu_torch.utils.testing import (SyntheticClips,
                                                        flagship_config)
    n_train, n_val, accum, epochs = 8, 2, 2, 2
    base = flagship_config(max_voxels=16000)

    def config(workers: int, stage_epochs: int = epochs, **rgb):
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, batch_size=1, grad_accum_steps=accum,
            log_every_steps=1, num_workers=workers,
            stages=(StageConfig(epochs=stage_epochs, learning_rate=1e-3,
                                loss="L_total"),)))
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, rgb=dataclasses.replace(cfg.model.rgb, **rgb)))

    train_ds = SyntheticClips(base, n_train, n_valid=100)
    val_cfg = flagship_config()
    val_ds = SyntheticClips(val_cfg, n_val, n_valid=100, first_seed=100)

    # the host's share: one whole sample, and its rulebook alone
    for name, ds in (("16k training", train_ds), ("40k validation", val_ds)):
        t0 = time.perf_counter()
        sample = ds[0]
        t_sample = time.perf_counter() - t0
        pc = ds.cfg.data.point_cloud
        nx, ny, nz = pc.grid_size
        t0 = time.perf_counter()
        build_rulebook(sample["voxel_coords"],
                       int(sample["voxel_valid"].sum()), (nz + 1, ny, nx),
                       ds.cfg.model.lidar.max_voxels_per_stage)
        print(f"host, one {name} clip: sample {t_sample:.3f} s, of which "
              f"the rulebook {time.perf_counter() - t0:.3f} s")

    if sweep:
        _host_pool_timings(sample, train_ds, n_train)

    total = {k: 0 for k in _counters()}

    def train(workdir, cfg, n_epochs, resume=False, clips=train_ds,
              val=val_ds, on_stage_start=None):
        """One run_training call, its launch counts checked and added to
        ``total``: (metrics, end state)."""
        end = {}
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_training(
            cfg, workdir, train_ds=clips, val_ds=val, resume=resume,
            on_stage_start=on_stage_start,
            on_stage_end=lambda i, st: end.update(_end_state(st)))
        torch.cuda.synchronize()
        end["seconds"] = time.perf_counter() - t0
        counts = _counts()
        steps, requests = len(clips) * n_epochs, len(val) * n_epochs
        expect = {"stem_conv": steps + requests,
                  "window_conv": 11 * (steps + requests),
                  "subm_conv": 10 * steps, "sparse_wgrad": 11 * steps}
        for k, n in expect.items():
            check(counts[k] == n, f"run_training: {k} launches {counts[k]} "
                  f"!= {n} ({steps} micro-steps, {requests} validation "
                  f"requests)")
            total[k] += n
        for key in ("overall_AP", "action_AP", "activity_AP", "score"):
            check(key in metrics and math.isfinite(metrics[key]),
                  f"run_training: metric {key}: {metrics.get(key)}")
        return metrics, end

    def spans(workdir):
        with open(os.path.join(workdir, "logs", "metrics.jsonl")) as f:
            log = [json.loads(line) for line in f]
        return [r for r in log if "time/train_s" in r]

    with tempfile.TemporaryDirectory() as root:
        def report(workers, workdir, n_epochs, metrics, end):
            check((end["optimizer"]["updates"], end["step"])
                  == (n_epochs * n_train // accum, n_epochs * n_train),
                  f"run_training: {end['optimizer']['updates']} updates at "
                  f"step {end['step']}")
            rows = spans(workdir)
            check(len(rows) == n_epochs, f"{len(rows)} epochs logged")
            rates = [n_train / r["time/train_s"] for r in rows]
            print(f"run_training, num_workers {workers} ({n_epochs} epochs "
                  f"of {n_train} clips, accumulation {accum}, {n_val} "
                  f"validation clips): {end['seconds']:.1f} s; training "
                  f"epochs {[round(r['time/train_s'], 2) for r in rows]} s = "
                  f"{[round(r, 3) for r in rates]} clips/s against the "
                  f"device's own {1 / step_device_s:.3f} clips/s (micro-step "
                  f"{step_device_s * 1e3:.2f} ms by CUDA events); evaluation "
                  f"{[round(r['time/eval_s'], 2) for r in rows]} s, "
                  f"checkpoint "
                  f"{[round(r['time/checkpoint_s'], 2) for r in rows]} s; "
                  f"metrics { {k: round(v, 6) for k, v in metrics.items()} }")

        # the whole seeded run, no decode workers
        whole_dir = os.path.join(root, "w0")
        whole_metrics, whole = train(whole_dir, config(0), epochs)
        report(0, whole_dir, epochs, whole_metrics, whole)
        for rel in ("logs/metrics.jsonl", "checkpoints/best.json",
                    "results/s0_e0/grouping.txt",
                    "results/s0_e1/grouping.txt"):
            check(os.path.exists(os.path.join(whole_dir, rel)),
                  f"run_training wrote no {rel}")

        # the same run cut after epoch 0 ...
        cut = os.path.join(root, "cut")
        first_metrics, first = train(cut, config(0, stage_epochs=1), 1)
        check(first["step"] == n_train, f"cut run ended at {first['step']}")

        # ... which one epoch with decode workers must equal ...
        for workers in ((4, 8) if sweep else (4,)):
            workdir = os.path.join(root, f"w{workers}")
            pooled_metrics, pooled = train(
                workdir, config(workers, stage_epochs=1), 1)
            report(workers, workdir, 1, pooled_metrics, pooled)
            _check_same_end(f"seeded epoch with {workers} workers against "
                            f"the epoch with none", pooled, first)
            check(pooled_metrics == first_metrics,
                  f"metrics with {workers} workers differ")

        # ... and which, resumed, must equal the whole run
        _, resumed = train(cut, config(0), epochs - 1, resume=True)
        _check_same_end("run resumed after epoch 0 against the "
                        "uninterrupted run", resumed, whole)

        workdir = os.path.join(root, "w0")
        _reset_counts()
        t0 = time.perf_counter()
        again = run_eval(config(0), workdir, val_ds=val_ds)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        eval_counts = _counts()
        check(eval_counts["stem_conv"] == n_val
              and eval_counts["window_conv"] == 11 * n_val,
              f"run_eval launches {eval_counts}")
        for k, v in again.items():
            check(v == whole_metrics[k], f"run_eval {k}: {v} != "
                  f"{whole_metrics[k]} after the checkpoint round trip")
        print(f"run_eval: {t_eval:.1f} s, the "
              f"{len(again)} metrics of the training run's last evaluation, "
              f"exactly")
        bf16_counts = _bf16_eval(config(0), workdir, val_ds, whole_metrics,
                                 n_val)

        _reset_counts()
        seen = {}
        t0 = time.perf_counter()
        nothing = run_training(
            config(0), workdir, train_ds=train_ds, val_ds=val_ds,
            resume=True, on_stage_start=lambda i, st: seen.update(
                step=st.step, updates=st.optimizer.updates))
        t_resume = time.perf_counter() - t0
        check(seen == {"step": epochs * n_train,
                       "updates": epochs * n_train // accum},
              f"resume restored {seen}")
        check(nothing == {} and not any(_counts().values()),
              f"the resumed run trained or evaluated again: {_counts()}")
        print(f"run_training(resume=True): {t_resume:.1f} s, restored step "
              f"{seen['step']}, no further step")

        _phase_i3d_checkpoint(root, config, train)
    return {k: total[k] + eval_counts[k] + bf16_counts[k] for k in total}


def _bf16_eval(cfg, workdir: str, val_ds, f32_metrics: dict,
               n_val: int) -> dict:
    """15f (phase 15 on phase 8's checkpoint and validation clips):
    run_eval with ``model.dtype`` bfloat16, what ``eval --set
    model.dtype=bfloat16`` runs: the float32 checkpoint served at bf16,
    its launches the bf16 kernels' only, its metrics finite beside the
    float32 evaluation's."""
    import torch
    from multimodal_gar_tpu_torch.train.loop import run_eval
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="bfloat16"))
    _reset_counts()
    t0 = time.perf_counter()
    metrics = run_eval(cfg16, workdir, val_ds=val_ds)
    torch.cuda.synchronize()
    counts = _counts()
    check(counts["stem_conv_bf16"] == n_val
          and counts["window_conv_bf16"] == 11 * n_val
          and counts["stem_conv"] == counts["window_conv"] == 0,
          f"15f bf16 run_eval launches {counts}")
    check(set(metrics) <= set(f32_metrics)
          and all(math.isfinite(v) for v in metrics.values()),
          f"15f bf16 run_eval metrics {metrics}")
    print(f"15f run_eval at model.dtype bfloat16 on phase 8's checkpoint: "
          f"{time.perf_counter() - t0:.1f} s, launches {counts}; metrics "
          + ", ".join(f"{k} {v:.6f} (float32 {f32_metrics[k]:.6f})"
                      for k, v in metrics.items()))
    return counts


def _phase_i3d_checkpoint(root: str, config, train) -> None:
    """One run with ``model.rgb.i3d_checkpoint``: a state dict under the
    published key names (the I3D's own, plus deeper endpoints, the logits
    head and num_batches_tracked, which the loader drops), drawn from a
    seed and written here. ``config`` and ``train`` are phase_cli's."""
    import torch
    from multimodal_gar_tpu_torch.models.i3d import InceptionI3d
    from multimodal_gar_tpu_torch.utils.testing import (SyntheticClips,
                                                        flagship_config,
                                                        randomize_)
    donor = InceptionI3d("Mixed_5c", device="cpu",
                         generator=torch.Generator().manual_seed(5))
    randomize_(donor, torch.Generator().manual_seed(6))
    ckpt = {k: v.clone() for k, v in donor.state_dict().items()}
    ckpt["logits.conv3d.weight"] = torch.zeros((400, 1024, 1, 1, 1))
    ckpt["logits.conv3d.bias"] = torch.zeros((400,))
    ckpt["Conv3d_1a_7x7.bn.num_batches_tracked"] = torch.tensor(7)
    path = os.path.join(root, "rgb_imagenet.pt")
    torch.save(ckpt, path)

    clip = torch.randn((1, 15, 96, 128, 3), device=DEVICE,
                       generator=torch.Generator(DEVICE).manual_seed(7))
    seen = {}

    def at_start(_, state):
        # the model's own I3D tensors as the run starts; their features are
        # computed after the run, outside its launch counts
        seen.update({k: v.detach().clone() for k, v in
                     state.model.rgb_backbone.i3d.state_dict().items()})

    cfg = config(0, stage_epochs=1, i3d_checkpoint=path)
    t0 = time.perf_counter()
    metrics, end = train(
        os.path.join(root, "i3d"), cfg, 1,
        clips=SyntheticClips(flagship_config(max_voxels=16000), 2,
                             n_valid=100, first_seed=50),
        val=SyntheticClips(flagship_config(), 1, n_valid=100, first_seed=60),
        on_stage_start=at_start)
    check(end["step"] == 2, f"run with an I3D checkpoint ended at step "
          f"{end['step']}")
    check(len(seen) == 45 * 5
          and all(torch.equal(v.cpu(), ckpt[k]) for k, v in seen.items()),
          "the I3D does not hold the checkpoint's tensors")
    kw = dict(center_slice=True, device=DEVICE)
    models_own = InceptionI3d("Mixed_4f", generator=torch.Generator(), **kw)
    models_own.load_state_dict(seen)
    loaded = InceptionI3d("Mixed_4f", generator=torch.Generator(), **kw)
    loaded.load_state_dict({k: ckpt[k] for k in loaded.state_dict()})
    seeded = InceptionI3d(
        "Mixed_4f", generator=torch.Generator().manual_seed(cfg.train.seed),
        **kw)
    with torch.no_grad():
        features = models_own.eval()(clip)
        want, other = loaded.eval()(clip), seeded.eval()(clip)
    check(torch.equal(features, want),
          "the model's I3D features are not the loaded weights'")
    _, away = rel_err(features, other)
    check(away > 0.1, f"the I3D features did not change (rel {away})")
    print(f"run_training with model.rgb.i3d_checkpoint: "
          f"{time.perf_counter() - t0:.1f} s; the I3D holds the file's "
          f"{len(seen)} tensors (Mixed_5b, Mixed_5c, logits and "
          f"num_batches_tracked dropped), its features on a clip equal "
          f"those of an I3D loaded with them directly and differ from the "
          f"seeded draw's by {away:.2f} of their largest value")


def _no_rulebook(fields: dict) -> dict:
    """The batch fields without the host rulebook."""
    return {k: v for k, v in fields.items() if k != "rulebook"}


def _event_ms(fn):
    """(fn's output, its device ms between one pair of CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _switch_no_rulebook(fields, fields16) -> dict:
    """Phase 9a: the sparse backbone without a rulebook at full width."""
    import torch
    from multimodal_gar_tpu_torch.data.rulebook import build_rulebook
    from multimodal_gar_tpu_torch.models.layers import seed_dropout
    from multimodal_gar_tpu_torch.ops.device_rulebook import device_rulebook
    from multimodal_gar_tpu_torch.train.train_state import (
        make_eval_step, make_optimizer, make_train_step)
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, flagship_config, people_on_voxels, with_model)
    cfg = flagship_config()
    caps = cfg.model.lidar.max_voxels_per_stage
    nx, ny, nz = cfg.data.point_cloud.grid_size
    shape = (nz + 1, ny, nx)
    host_rb = fields["rulebook"]
    batch = batch_from_numpy(_no_rulebook(fields), DEVICE)
    coords, valid = batch.voxel_coords, batch.voxel_valid
    maps = device_rulebook(coords, valid, shape, caps)
    keys = [k for k in host_rb if k in maps]
    check(len(keys) == 13 and all(
        torch.equal(maps[k].cpu(), torch.from_numpy(host_rb[k]))
        for k in keys), "device-built maps differ from the host rulebook's")
    map_ms = median_ms(lambda: device_rulebook(coords, valid, shape, caps))
    n_valid = int(fields["voxel_valid"][0].sum())
    t0 = time.perf_counter()
    build_rulebook(fields["voxel_coords"][0], n_valid, shape, caps,
                   x_window=False)
    host_nbr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_rulebook(fields["voxel_coords"][0], n_valid, shape, caps)
    host_s = time.perf_counter() - t0
    print(f"device-built maps at 40k ({n_valid} voxels): the host "
          f"rulebook's {len(keys)} nbr / down / coords / count maps, exactly;"
          f" {map_ms:.3f} ms by CUDA events against the host rulebook's "
          f"{host_s:.3f} s ({host_nbr_s:.3f} s without the x-window maps); "
          f"sites cut off by the caps: "
          f"{[int(maps[f'dropped_{k}'][0]) for k in (1, 2, 3)]}")

    nbr_cfg = with_model(cfg, lidar=dict(x_window=False))
    ref = make_eval_step(_model(nbr_cfg, DEVICE))(
        batch_from_numpy(fields, DEVICE))
    eval_step = make_eval_step(_model(cfg, DEVICE))
    eval_step(batch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    want = {"stem_conv": 1, "window_conv": 0, "subm_conv": 11,
            "sparse_wgrad": 0}
    times = []
    for i in range(3):
        before = _counts()
        out, ms = _event_ms(lambda: eval_step(batch))
        times.append(ms)
        ran = {k: _counts()[k] - before[k] for k in want}
        check(ran == want, f"no-rulebook request {i}: launches {ran}, "
              f"expected {want}")
        check_outputs(out, batch.person_valid)
        refs = dict(_outputs(ref))
        check(all(torch.equal(t, refs[n]) for n, t in _outputs(out))
              and torch.equal(out.group_ids, ref.group_ids),
              f"no-rulebook request {i} differs from the nbr-map request")
    counts = _counts()
    print(f"no-rulebook requests (40k): {[round(t, 2) for t in times]} ms "
          f"by CUDA events, launches per request {want}, outputs bit for "
          f"bit the nbr-map request's, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del eval_step, ref, out

    cfg16 = flagship_config(max_voxels=16000)
    f16 = people_on_voxels(fields16, cfg16)
    batch16 = batch_from_numpy(_no_rulebook(f16), DEVICE)
    host16 = batch_from_numpy(f16, DEVICE)
    model = _model(with_model(cfg16, lidar=dict(x_window=False)), DEVICE)
    grads = []
    for b in (host16, batch16):
        seed_dropout(model, 0, 0)
        grads.append(_grads(model, b))
    worst = max(rel_err(g, grads[0][k])[1] for k, g in grads[1].items())
    check(worst <= 1e-6, f"no-rulebook gradients vs host maps: rel err "
          f"{worst}")
    opt = make_optimizer(model.parameters(), cfg16.train.stages[0],
                         steps_per_epoch=64, grad_accum=8,
                         gamma=cfg16.train.lr_decay_gamma)
    step = make_train_step(model, opt, "L_total")
    # K3: 11 forward layers and 10 data gradients (conv_input's input, the
    # voxel features, needs none)
    want = {"stem_conv": 1, "window_conv": 0, "subm_conv": 21,
            "sparse_wgrad": 11}
    _reset_counts()
    step_ms = []
    for i in range(4):
        before = _counts()
        metrics, ms = _event_ms(lambda: step(batch16))
        step_ms.append(ms)
        ran = {k: _counts()[k] - before[k] for k in want}
        check(ran == want, f"no-rulebook micro-step {i}: launches {ran}, "
              f"expected {want}")
        check(math.isfinite(metrics["loss"].item())
              and metrics["nonfinite_grads"].item() == 0.0,
              f"no-rulebook micro-step {i}: {metrics}")
    counts = {k: counts[k] + v for k, v in _counts().items()}
    print(f"no-rulebook train micro-steps (16k): "
          f"{[round(t, 2) for t in step_ms]} ms by CUDA events, launches per "
          f"micro-step {want} (K3: 11 forward + 10 data-gradient); "
          f"gradients vs the host maps' micro-step: max rel err {worst:.3e} "
          f"over {len(grads[0])} tensors")
    return counts


def _grads(model, batch) -> dict:
    from multimodal_gar_tpu_torch.utils.testing import train_loss_and_grads
    return train_loss_and_grads(model, batch)[1]


def _switch_dense_pool(fields) -> dict:
    """Phase 9b: the dense and the exact grid-pool query at full width."""
    import torch
    from multimodal_gar_tpu_torch.models.lidar_backbone import mean_vfe
    from multimodal_gar_tpu_torch.models.roi_grid_pool import roi_grid_points
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, flagship_config, people_on_voxels, with_model)
    cfg = flagship_config()
    batch = batch_from_numpy(people_on_voxels(fields, cfg), DEVICE)
    variants = {"culled": cfg,
                "pool_cull_k=0": with_model(cfg, lidar=dict(pool_cull_k=0)),
                "voxel_query_exact": with_model(
                    cfg, lidar=dict(voxel_query_exact=True))}
    want = {"stem_conv": 1, "window_conv": 11, "subm_conv": 0,
            "sparse_wgrad": 0}
    counts = dict.fromkeys(_counters(), 0)
    outs, report = {}, []
    for name, vcfg in variants.items():
        model = _model(vcfg, DEVICE)
        eval_step = make_eval_step(model)
        eval_step(batch)                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        times = []
        for i in range(3):
            before = _counts()
            out, ms = _event_ms(lambda: eval_step(batch))
            times.append(ms)
            ran = {k: _counts()[k] - before[k] for k in want}
            check(ran == want, f"{name} request {i}: launches {ran}")
            check_outputs(out, batch.person_valid)
        counts = {k: counts[k] + v for k, v in _counts().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        outs[name] = out
        if name != "culled":
            refs = dict(_outputs(outs["culled"]))
            worst = max(rel_err(t, refs[n])[1] for n, t in _outputs(out))
            check(worst <= MODEL_TOL, f"{name} vs culled: rel err {worst}")
            same_ids = torch.equal(out.group_ids, outs["culled"].group_ids)
            report.append(f"{name}: max rel err vs culled {worst:.3e}, "
                          f"group_ids equal {same_ids}")
        print(f"grid pool [{name}] requests (40k): "
              f"{[round(t, 2) for t in times]} ms by CUDA events, launches "
              f"per request {want}, peak {peak:.2f} GiB")
        if name == "culled":
            lb = model.lidar_backbone
    for line in report:
        print(line)

    # the neighbour sets of the culled and the dense query, and the dense
    # query's peak memory, per scale
    pool = lb.roi_grid_pool
    with torch.inference_mode():
        feats = mean_vfe(batch.voxels, batch.voxel_num_points) \
            * batch.voxel_valid[..., None]
        ms = lb.backbone3d(SparseTensor(feats, batch.voxel_coords,
                                        batch.voxel_valid, lb.spatial_shape),
                           batch.rulebook)
        g3 = pool.grid_size ** 3
        grid = roi_grid_points(batch.boxes3d, pool.grid_size).reshape(
            1, -1, 3)
        grid_valid = batch.person_valid.repeat_interleave(g3, dim=1)
        for src in pool.sources:
            layer = getattr(pool, f"pool_{src}")
            cull = layer.cull_k
            rows_c, empty_c, _ = layer.neighbours(ms[src], grid, grid_valid)
            layer.cull_k = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (rows_d, empty_d, _), q_ms = _event_ms(
                lambda: layer.neighbours(ms[src], grid, grid_valid))
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            layer.cull_k = cull
            differ = ((empty_c != empty_d)
                      | ((rows_c != rows_d).any(-1) & ~empty_d)) & grid_valid
            print(f"grid pool {src} ({int(ms[src].valid.sum())} voxels, "
                  f"{int(grid_valid.sum())} queries): "
                  f"{int(differ.sum())} queries with another neighbour set "
                  f"culled vs dense, {int((~empty_d & grid_valid).sum())} "
                  f"with neighbours; dense query {q_ms:.3f} ms by CUDA "
                  f"events, peak {peak:.1f} MiB above the resident memory")
    return counts


def _switch_trainable_i3d(fields16) -> dict:
    """Phase 9c: 8 full-width micro-steps with a trainable I3D, remat off
    and on, then an eval request of the same model."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import (
        make_eval_step, make_optimizer, make_train_step)
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, flagship_config, people_on_voxels, with_model)
    cfg16 = flagship_config(max_voxels=16000)
    batch = batch_from_numpy(people_on_voxels(fields16, cfg16), DEVICE)
    accum = cfg16.train.grad_accum_steps
    check(accum == 8, f"accumulation {accum}, expected 8")
    want = {"stem_conv": 0, "window_conv": 11, "subm_conv": 10,
            "sparse_wgrad": 11}
    counts = dict.fromkeys(_counters(), 0)
    losses = {}
    for remat in (False, True):
        cfg = with_model(cfg16, rgb=dict(i3d_freeze=False, i3d_remat=remat))
        model = _model(cfg, DEVICE)
        i3d = model.rgb_backbone.i3d
        opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                             steps_per_epoch=64, grad_accum=accum,
                             gamma=cfg.train.lr_decay_gamma)
        step = make_train_step(model, opt, "L_total")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        times, losses[remat] = [], []
        for i in range(1, accum + 1):
            weights = [p.detach().clone() for p in i3d.parameters()]
            stats = [b.detach().clone() for b in i3d.buffers()]
            before = _counts()
            metrics, ms = _event_ms(lambda: step(batch))
            times.append(ms)
            ran = {k: _counts()[k] - before[k] for k in want}
            check(ran == want, f"trainable I3D micro-step {i}: launches "
                  f"{ran}, expected {want}")
            loss = metrics["loss"].item()
            check(math.isfinite(loss)
                  and metrics["nonfinite_grads"].item() == 0.0,
                  f"trainable I3D micro-step {i}: {metrics}")
            losses[remat].append(loss)
            moved = sum(not torch.equal(p, q)
                        for p, q in zip(i3d.parameters(), weights))
            check(moved == (len(weights) if i == accum else 0),
                  f"micro-step {i}: {moved} of {len(weights)} I3D weights "
                  f"moved")
            check(all(not torch.equal(b, q)
                      for b, q in zip(i3d.buffers(), stats)),
                  f"micro-step {i}: an I3D BatchNorm statistic stayed")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = {k: counts[k] + v for k, v in _counts().items()}
        print(f"trainable I3D, i3d_remat {remat}: micro-steps "
              f"{[round(t, 2) for t in times]} ms by CUDA events (median "
              f"{statistics.median(times):.2f}), peak {peak:.2f} GiB; "
              f"launches per micro-step {want}; I3D weights moved at "
              f"micro-step {accum} only, its BatchNorm statistics at each")
        eval_step = make_eval_step(model)
        _reset_counts()
        out = eval_step(batch)
        ran = _counts()
        check(ran["stem_conv"] == 1, f"eval request of the trained model: "
              f"stem launches {ran['stem_conv']}")
        check_outputs(out, batch.person_valid)
        counts = {k: counts[k] + v for k, v in ran.items()}
        del model, opt, step, eval_step, out
        torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                    losses[False]))
    check(worst <= 1e-5, f"losses with and without remat: rel err {worst}")
    print(f"trainable I3D losses, remat on vs off: max rel err {worst:.3e} "
          f"over {accum} micro-steps; eval request of the trained model: "
          f"stem launches 1")
    return counts


def _switch_tiny():
    """Phase 9d: tiny_config card against CPU: the no-rulebook forward, the
    three legacy models and a trainable-I3D train step."""
    import numpy as np
    import torch
    from multimodal_gar_tpu_torch.models.registry import build_model
    from multimodal_gar_tpu_torch.utils.testing import (
        randomize_, synthetic_batch_numpy, tiny_config, with_model)
    cfg = tiny_config()
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    worst, n = _card_vs_cpu(cfg, _no_rulebook(fields), "tiny no-rulebook")
    print(f"tiny no-rulebook forward, card vs CPU: max rel err {worst:.3e} "
          f"over {n} outputs, group_ids equal")

    rng = np.random.default_rng(0)
    valid = torch.from_numpy(np.array([[True] * 7 + [False]] * 2))
    feats = torch.from_numpy(rng.normal(size=(2, 8, 1024)).astype(np.float32))
    xy = rng.uniform(0, 50, (2, 8, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 20, (2, 8, 2))], -1).astype(np.float32))
    gids = torch.from_numpy(rng.integers(0, 3, (2, 8)).astype(np.int32))
    cases = {"GARNet": (feats, boxes, gids, valid),
             "TranSG": (feats[..., :512], boxes / 70.0, valid),
             "ActBaseline": (feats[..., :256], boxes, valid)}
    for name, args in cases.items():
        outs = {}
        for dev in ("cpu", DEVICE):
            model = build_model(cfg, name, device=dev,
                                generator=torch.Generator().manual_seed(0))
            randomize_(model, torch.Generator().manual_seed(1))
            with torch.inference_mode():
                out = model.eval()(*(a.to(dev) for a in args))
            outs[dev] = [t.cpu() for t in (
                (out[0],) + out[1] + out[2] if name == "GARNet" else (out,))]
        worst = max(rel_err(g, r)[1] for g, r in zip(outs[DEVICE],
                                                     outs["cpu"]))
        check(worst <= MODEL_TOL, f"{name} card vs CPU: rel err {worst}")
        print(f"legacy [{name}] card vs CPU: max rel err {worst:.3e} over "
              f"{len(outs['cpu'])} outputs")

    # the trainable I3D to Mixed_3b: past it the max pools' argmax turns on
    # values a rounding apart and float32 gradients of any two
    # implementations part by percents (tests/test_torch_i3d_train.py)
    print(_tiny_train_card_vs_cpu(
        with_model(cfg, rgb=dict(i3d_freeze=False, i3d_endpoint="Mixed_3b")),
        fields, "tiny trainable-I3D train step (I3D to Mixed_3b)"))


def phase_switches(fields, fields16) -> dict:
    """Phase 9: the switches that raised before: the sparse backbone
    without a rulebook, the dense and the exact grid pool, the trainable
    I3D, and the tiny card-vs-CPU checks of these and the legacy models.
    Each full-width path reads the launch counts from 0; returns their
    sum."""
    paths = (timed("9a no rulebook", _switch_no_rulebook, fields, fields16),
             timed("9b dense and exact grid pool", _switch_dense_pool,
                   fields),
             timed("9c trainable I3D", _switch_trainable_i3d, fields16))
    timed("9d tiny switches, card vs CPU", _switch_tiny)
    return {k: sum(c[k] for c in paths) for k in paths[0]}


# ---------------------------------------------------------------------------
# phase 10: the detector zoo's first slice
# ---------------------------------------------------------------------------

DET_CLASSES = ("Car", "Pedestrian", "Cyclist")


def _kitti_frames(name: str):
    from multimodal_gar_tpu_torch.detection.detectors import default_config
    from multimodal_gar_tpu_torch.utils.testing import SyntheticKittiFrames
    return SyntheticKittiFrames(default_config(name).point_cloud_range,
                                seed=0)


def _det_batch(name: str, indices, x_window: bool = False):
    """Synthetic KITTI frames through the port's assemble_det_batch at 5
    points per voxel and a 16,000-voxel cap, on the card."""
    from multimodal_gar_tpu_torch.data.detbatch import assemble_det_batch
    from multimodal_gar_tpu_torch.detection.detectors import default_config
    return assemble_det_batch(_kitti_frames(name), indices,
                              default_config(name).voxel_size, 16000,
                              max_points_per_voxel=5, x_window=x_window,
                              device=DEVICE)


def _det_model(name: str, device=DEVICE, **over):
    """Detector ``name`` at its default (KITTI) config through the
    registry, its weights drawn from seed 0; ``over`` replaces fields of
    its DetectorConfig (then built by the zoo's own builder)."""
    import torch
    from multimodal_gar_tpu_torch.detection import build_detector
    from multimodal_gar_tpu_torch.models import build_model
    from multimodal_gar_tpu_torch.utils.testing import kitti_config
    gen = torch.Generator().manual_seed(0)
    model = build_model(kitti_config(name), name, device=device,
                        generator=gen)
    if over:
        other = build_detector(name, dataclasses.replace(model.cfg, **over),
                               device=device,
                               generator=torch.Generator().manual_seed(0))
        other.load_state_dict(model.state_dict())
        model = other
    return model


def _det_outputs(preds, prefix=""):
    """(name, tensor) of every tensor of a detector's output dict."""
    import torch
    for k in sorted(preds):
        v = preds[k]
        if isinstance(v, dict):
            yield from _det_outputs(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def _check_predict(out, batch_size: int, k: int, what: str) -> None:
    import torch
    check(out["boxes"].shape == (batch_size, k, 7)
          and out["valid"].dtype == torch.bool, f"{what}: predict shapes "
          f"{tuple(out['boxes'].shape)}")
    v = out["valid"]
    check(torch.isfinite(out["boxes"][v]).all()
          and torch.isfinite(out["scores"]).all(), f"{what}: not finite")
    check(torch.all(out["labels"][~v] == 0)
          and torch.all(out["labels"][v] >= 1), f"{what}: labels")


def _serve(model, batch, want: dict, what: str, n: int = 3):
    """``n`` requests (eval forward + predict) of ``model`` on ``batch``,
    each launching exactly ``want``; returns (last preds, last predict
    output, request ms by CUDA events, predict ms by CUDA events)."""
    import torch
    model.eval()

    def request():
        with torch.no_grad():
            preds = model(batch)
            return preds, model.predict(preds)
    request()                      # warm-up: cuDNN times its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    req_ms, post_ms = [], []
    for i in range(n):
        before = _counts()
        (preds, out), ms = _event_ms(request)
        ran = {key: _counts()[key] - before[key] for key in want}
        check(ran == want, f"{what} request {i}: launches {ran}, expected "
              f"{want}")
        for name, t in _det_outputs(preds):
            if t.is_floating_point():
                check(torch.isfinite(t).all(), f"{what}: {name} not finite")
        with torch.no_grad():
            _, pms = _event_ms(lambda: model.predict(preds))
        req_ms.append(ms)
        post_ms.append(pms)
    return preds, out, req_ms, post_ms


def _train(model, batch, want: dict, what: str, steps: int = 4):
    """``steps`` detector train steps (AdamW 3e-3, clip 10) at ``batch``,
    each launching exactly ``want``, the loss finite, no gradient
    non-finite and the weights moving; returns the step ms by CUDA events
    (the first includes cuDNN's timing of its algorithms; the peak memory
    is reset after it)."""
    import torch
    from multimodal_gar_tpu_torch.detection.train import (
        create_det_train_state, make_det_train_step)
    state = create_det_train_state(model)
    step = make_det_train_step(model, state, seed=0)
    times = []
    for i in range(steps):
        prev = [p.detach().clone() for p in state.params]
        before = _counts()
        metrics, ms = _event_ms(lambda: step(batch))
        ran = {key: _counts()[key] - before[key] for key in want}
        check(ran == want, f"{what} step {i}: launches {ran}, expected "
              f"{want}")
        loss = metrics["loss"].item()
        check(math.isfinite(loss) and metrics["nonfinite_grads"].item() == 0,
              f"{what} step {i}: loss {loss}, {metrics['nonfinite_grads']}")
        moved = sum(not torch.equal(p, q) for p, q in zip(state.params,
                                                            prev))
        check(moved > 0.9 * len(prev), f"{what} step {i}: {moved} of "
              f"{len(prev)} parameter tensors moved")
        times.append(ms)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
    return times, loss


def _peak_gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _stages(model, batch) -> dict:
    """ms by CUDA events of each stage of one SECOND request (after
    warm-up): the sparse backbone, conv_out, the BEV scatter, the BEV
    backbone, the head, the anchor decode and the NMS post-processing."""
    import torch
    from multimodal_gar_tpu_torch.detection.bev import (cudnn_autotuned,
                                                        sparse_to_dense_bev)
    from multimodal_gar_tpu_torch.detection.dense_heads import (
        decode_anchor_preds)
    from multimodal_gar_tpu_torch.detection.detectors import (_coder,
                                                              anchor_set_for)
    from multimodal_gar_tpu_torch.detection.post import post_processing
    from multimodal_gar_tpu_torch.detection.vfe import mean_vfe
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
    t, cfg, out = model.trunk, model.cfg, {}

    def stage(name, fn):
        res, ms = _event_ms(fn)
        out[name] = round(ms, 3)
        return res
    with torch.no_grad(), cudnn_autotuned():
        feats = mean_vfe(batch.voxels, batch.voxel_num_points) \
            * batch.voxel_valid[..., None]
        st = SparseTensor(feats, batch.voxel_coords, batch.voxel_valid,
                          cfg.sparse_shape)
        ms = stage("backbone_3d", lambda: t.backbone_3d(st, batch.rulebook))
        co = stage("conv_out", lambda: t.conv_out(ms["x_conv4"]))
        bev = stage("to_bev", lambda: sparse_to_dense_bev(co))
        bev2 = stage("backbone_2d", lambda: t.backbone_2d(bev))
        preds = stage("head", lambda: model.dense_head(bev2))
        cls, boxes = stage("decode", lambda: decode_anchor_preds(
            preds, anchor_set_for(cfg), _coder(cfg), cfg.head))
        stage("post", lambda: post_processing(cls, boxes, cfg.nms))
    return out


class _Recorder:
    """A kernel wrapper in a module's namespace that records each call's
    positional inputs (keywords, such as kernel D's tap columns, pass
    through unrecorded: a replay makes its own); its ``launches`` are the
    wrapped function's."""

    def __init__(self, name: str, fn, calls: list):
        self.name, self.fn, self.calls = name, fn, calls

    def __call__(self, *args, **kwargs):
        self.calls.append((self.name, [a.detach().clone() for a in args]))
        return self.fn(*args, **kwargs)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


def _sparse_sites() -> dict:
    """{kernel: (module, attribute, plain version)}: the functions through
    which the sparse layers launch K3, window_conv and K4 (at bf16 their
    bf16 variants and kernel D)."""
    import multimodal_gar_tpu_torch.ops.kernels.subm_conv as k3m
    import multimodal_gar_tpu_torch.ops.kernels.window_conv as wcm
    from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
        sparse_wgrad_plain)
    return {"subm_conv": (k3m, "_subm_forward", k3m.subm_conv_plain),
            "window_conv": (wcm, "_window_forward", wcm.window_conv_plain),
            "sparse_wgrad": (k3m, "sparse_wgrad", sparse_wgrad_plain)}


def _recorded_launches(run, sites: dict = None) -> tuple:
    """Every launch through ``sites`` (default ``_sparse_sites()``) of
    ``run()`` recorded with a copy of its inputs: ([(kernel, inputs)] in
    launch order, {kernel: (its launch, its plain version)})."""
    sites = sites or _sparse_sites()
    calls = []
    originals = {name: getattr(mod, attr)
                 for name, (mod, attr, _) in sites.items()}
    for name, (mod, attr, _) in sites.items():
        setattr(mod, attr, _Recorder(name, originals[name], calls))
    try:
        run()
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, originals[name])
    return calls, {name: (originals[name], sites[name][2])
                   for name in sites}


def _det_kernel_checks(runs, want: dict, what: str) -> dict:
    """Every K3, window_conv and K4 launch of ``runs`` recorded with its
    inputs, then each replayed through the kernel and its plain version at
    KERNEL_TOL. ``runs``: (model, batch, train) triples; a training run is
    one forward and backward of the loss (K3 forward and data gradient, K4),
    an eval run one request. ``want``: the launches per kernel these runs
    make. Returns {kernel: (max abs err, max rel err)}."""
    import torch

    def run():
        for model, batch, train in runs:
            if train:
                model.train()
                model.loss(model(batch), batch)["loss"].backward()
                model.zero_grad(set_to_none=True)
            else:
                with torch.no_grad():
                    model.eval()(batch)
    calls, kernels = _recorded_launches(run)
    seen = {name: sum(c[0] == name for c in calls) for name in kernels}
    check(seen == want, f"{what}: launches recorded {seen}, expected {want}")
    worst = {}
    with torch.no_grad():
        for i, (name, args) in enumerate(calls):
            got = kernels[name][0](*args)
            err, rel = rel_err(got, kernels[name][1](*args))
            check(rel <= KERNEL_TOL, f"{what}: {name} launch {i} "
                  f"{[tuple(a.shape) for a in args]} rel err {rel}")
            a, r = worst.get(name, (0.0, 0.0))
            worst[name] = (max(a, err), max(r, rel))
    print(f"{what}: each of {len(calls)} launches ({seen}) against its "
          f"plain version on its own inputs, max (abs, rel) err "
          f"{ {k: (f'{a:.3e}', f'{r:.3e}') for k, (a, r) in worst.items()} }")
    return worst


def _worst(*errs: dict) -> dict:
    """The larger (abs, rel) error of each kernel over ``errs``."""
    out = {}
    for e in errs:
        for k, (a, r) in e.items():
            pa, pr = out.get(k, (0.0, 0.0))
            out[k] = (max(pa, a), max(pr, r))
    return out


def _det_second():
    """10a: SECOND at its default config."""
    import torch
    from multimodal_gar_tpu_torch.detection.post import (class_agnostic_nms,
                                                         post_processing)
    from multimodal_gar_tpu_torch.utils.profiling import time_fn
    batch = _det_batch("SECOND", [0], x_window=True)
    n_vox = int(batch.voxel_valid.sum())
    model = _det_model("SECOND")
    check(model.cfg.grid_size == (1408, 1600, 40)
          and model.cfg.sparse_shape == (41, 1600, 1408),
          f"SECOND geometry {model.cfg.grid_size}")
    from multimodal_gar_tpu_torch.detection.detectors import anchor_set_for
    n_anchors = anchor_set_for(model.cfg).anchors.shape[0]
    check(n_anchors == 211200, f"{n_anchors} anchors")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    # predict's NMS: one call a frame, the words and the sweep kernel each
    nms = {"nms_bev_words": 1, "nms_sweep": 1}
    nbr = {"subm_conv": 11, "window_conv": 0, "sparse_wgrad": 0, **nms}
    preds, out, req_ms, post_ms = _serve(model, batch, nbr, "SECOND")
    check(tuple(preds["cls_preds"].shape) == (1, 200, 176, 18),
          f"SECOND cls_preds {tuple(preds['cls_preds'].shape)}")
    _check_predict(out, 1, model.cfg.nms.nms_post_maxsize, "SECOND")
    peak = _peak_gib()

    def request():
        with torch.no_grad():
            return model.predict(model(batch))
    req_s, _ = time_fn(request, iters=5, warmup=1)
    with torch.no_grad():
        from multimodal_gar_tpu_torch.detection.dense_heads import (
            decode_anchor_preds)
        from multimodal_gar_tpu_torch.detection.detectors import _coder
        cls, boxes = decode_anchor_preds(preds, anchor_set_for(model.cfg),
                                         _coder(model.cfg), model.cfg.head)
        score = torch.sigmoid(cls[0]).max(-1).values
        nms_s, _ = time_fn(lambda: class_agnostic_nms(
            score, boxes[0], model.cfg.nms), iters=5, warmup=1)
        # every box above the threshold: the whole 1024-box sweep
        all_in = dataclasses.replace(model.cfg.nms, score_thresh=0.0)
        full_s, (_, _, kept) = time_fn(lambda: class_agnostic_nms(
            score, boxes[0], all_in), iters=5, warmup=1)
        # these detections (random weights score below the threshold) go
        # to the KITTI evaluation (10d)
        detections = post_processing(cls, boxes, all_in)
    print(f"10a SECOND ({n_vox} voxels, 211,200 anchors): requests "
          f"{[round(t, 2) for t in req_ms]} ms by CUDA events (time_fn "
          f"{req_s * 1e3:.2f} ms), predict {[round(t, 2) for t in post_ms]}"
          f" ms of which the NMS of one frame {nms_s * 1e3:.2f} ms "
          f"({int(out['valid'].sum())} boxes above the score threshold; "
          f"with all {model.cfg.nms.nms_pre_maxsize} in the sweep "
          f"{full_s * 1e3:.2f} ms, {int(kept.sum())} kept), peak "
          f"{peak:.2f} GiB; launches per request {nbr}")
    counts = _counts()
    print(f"10a SECOND request by stage, ms by CUDA events: "
          f"{_stages(model, batch)}")

    xw = _det_model("SECOND", x_window=True)
    _reset_counts()
    want = {"subm_conv": 0, "window_conv": 11, "sparse_wgrad": 0, **nms}
    xpreds, xout, xms, _ = _serve(xw, batch, want, "SECOND x-window")
    worst = 0.0
    refs = dict(_det_outputs(preds))
    for name, t in _det_outputs(xpreds):
        _, rel = rel_err(t, refs[name])
        check(rel <= MODEL_TOL, f"x-window {name}: rel err {rel}")
        worst = max(worst, rel)
    check(torch.equal(xout["valid"], out["valid"])
          and torch.equal(xout["labels"], out["labels"]),
          "x-window predict differs from the nbr path's")
    counts = {k: counts[k] + v for k, v in _counts().items()}
    print(f"10a SECOND x-window: requests {[round(t, 2) for t in xms]} ms, "
          f"launches per request {want}; outputs vs the nbr path max rel "
          f"err {worst:.3e}, predict's valid sets and labels equal")

    nob = dataclasses.replace(batch, rulebook=None)
    _reset_counts()
    npreds, nout, nms_, _ = _serve(model, nob, nbr, "SECOND no rulebook")
    check(all(torch.equal(t, refs[n]) for n, t in _det_outputs(npreds))
          and all(torch.equal(nout[k], out[k]) for k in out),
          "no-rulebook outputs differ from the nbr path's")
    counts = {k: counts[k] + v for k, v in _counts().items()}
    print(f"10a SECOND no rulebook: requests {[round(t, 2) for t in nms_]}"
          f" ms, launches per request {nbr}, outputs bit for bit the nbr "
          f"path's")

    batch2 = _det_batch("SECOND", [0, 1])
    _reset_counts()
    want = {"subm_conv": 21, "window_conv": 0, "sparse_wgrad": 11,
            "nms_bev_words": 0, "nms_sweep": 0}
    times, loss = _train(model, batch2, want, "SECOND")
    counts = {k: counts[k] + v for k, v in _counts().items()}
    print(f"10a SECOND train, batch 2: steps {[round(t, 2) for t in times]}"
          f" ms by CUDA events, last loss {loss:.4f}, peak {_peak_gib():.2f}"
          f" GiB; launches per step {want} (K3: 11 forward + 10 data "
          f"gradient)")
    errs = _det_kernel_checks(
        [(model, batch, False), (xw, batch, False), (model, batch2, True)],
        {"subm_conv": 32, "window_conv": 11, "sparse_wgrad": 11},
        "10a SECOND, a request on each path and a training step at batch 2")
    del model, xw
    return counts, detections, batch, errs


def _det_voxelrcnn():
    """10b: VoxelRCNN-Det at its default config."""
    import torch
    batch = _det_batch("VoxelRCNN-Det", [0])
    model = _det_model("VoxelRCNN-Det")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    # the proposal NMS and predict's NMS, each the words and the sweep
    want = {"subm_conv": 11, "window_conv": 0, "sparse_wgrad": 0,
            "nms_bev_words": 2, "nms_sweep": 2}
    preds, out, req_ms, post_ms = _serve(model, batch, want,
                                         "VoxelRCNN-Det")
    n_rois = model.roi_cfg.test_nms.nms_post_maxsize
    check(tuple(preds["rois"].shape) == (1, n_rois, 7),
          f"rois {tuple(preds['rois'].shape)}")
    # the final NMS selects among the RoIs
    _check_predict(out, 1, min(model.cfg.nms.nms_post_maxsize, n_rois),
                   "VoxelRCNN-Det")
    with torch.no_grad():
        bev, ms = model.trunk(batch)
        _, pool_ms = _event_ms(lambda: model.roi_grid_pool(
            ms, preds["rois"], preds["roi_valid"]))
    peak = _peak_gib()
    counts = _counts()
    print(f"10b VoxelRCNN-Det: requests {[round(t, 2) for t in req_ms]} ms "
          f"by CUDA events ({int(preds['roi_valid'].sum())} of {n_rois} "
          f"RoIs valid), the grid pool {pool_ms:.2f} ms of a request, "
          f"predict {[round(t, 2) for t in post_ms]} ms, peak {peak:.2f} "
          f"GiB; launches per request {want}")
    batch2 = _det_batch("VoxelRCNN-Det", [0, 1])
    _reset_counts()
    # the proposal NMS of each image
    want = {"subm_conv": 21, "window_conv": 0, "sparse_wgrad": 11,
            "nms_bev_words": 2, "nms_sweep": 2}
    times, loss = _train(model, batch2, want, "VoxelRCNN-Det")
    counts = {k: counts[k] + v for k, v in _counts().items()}
    print(f"10b VoxelRCNN-Det train, batch 2 ("
          f"{model.roi_cfg.sampler.roi_per_image} sampled RoIs each): steps "
          f"{[round(t, 2) for t in times]} ms by CUDA events, last loss "
          f"{loss:.4f}, peak {_peak_gib():.2f} GiB; launches per step "
          f"{want}")
    errs = _det_kernel_checks(
        [(model, batch, False), (model, batch2, True)],
        {"subm_conv": 32, "window_conv": 0, "sparse_wgrad": 11},
        "10b VoxelRCNN-Det, a request and a training step at batch 2")
    return counts, errs


def _det_others():
    """10c: PointPillar, PillarNet and CenterPoint at their defaults."""
    import torch
    counts = None
    for name in ("PointPillar", "PillarNet", "CenterPoint"):
        k3 = 0 if "Pillar" in name else 11
        batch = _det_batch(name, [0])
        model = _det_model(name)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        want = {"subm_conv": k3, "window_conv": 0, "sparse_wgrad": 0,
                "nms_bev_words": 1, "nms_sweep": 1}
        preds, out, req_ms, _ = _serve(model, batch, want, name, n=1)
        req_peak = _peak_gib()
        _check_predict(out, 1, model.cfg.nms.nms_post_maxsize, name)
        want = {"subm_conv": 2 * k3 - (k3 > 0), "window_conv": 0,
                "sparse_wgrad": k3, "nms_bev_words": 0, "nms_sweep": 0}
        times, loss = _train(model, _det_batch(name, [0, 1]), want, name,
                             steps=2)
        c = _counts()
        counts = c if counts is None else {key: counts[key] + v
                                           for key, v in c.items()}
        print(f"10c {name}: request {req_ms[0]:.2f} ms (peak {req_peak:.2f}"
              f" GiB), train steps (batch 2) {[round(t, 2) for t in times]}"
              f" ms by CUDA events, loss {loss:.4f}, peak of the second "
              f"{_peak_gib():.2f} GiB; "
              f"{int(batch.voxel_valid.sum())} voxels, output "
              f"{ {n: tuple(t.shape) for n, t in _det_outputs(preds)} }")
        del model
    return counts


def _det_eval(out, batch):
    """10d: the KITTI R40 evaluation of 10a's predictions (every box into
    the NMS) against the frame's GT."""
    import numpy as np
    from multimodal_gar_tpu_torch.eval.kitti_eval import (FrameAnnotations,
                                                          evaluate)
    frames = []
    for i in range(out["valid"].shape[0]):
        v = out["valid"][i].cpu().numpy()
        gv = batch.gt_valid[i].cpu().numpy()
        gt_cls = batch.gt_classes[i].cpu().numpy()[gv]
        frames.append(FrameAnnotations(
            gt_boxes=batch.gt_boxes[i].cpu().numpy()[gv],
            gt_names=[DET_CLASSES[c - 1] for c in gt_cls],
            gt_difficulty=np.zeros(int(gv.sum()), np.int32),
            det_boxes=out["boxes"][i].cpu().numpy()[v],
            det_names=[DET_CLASSES[c - 1] for c in
                       out["labels"][i].cpu().numpy()[v]],
            det_scores=out["scores"][i].cpu().numpy()[v]))
    t0 = time.perf_counter()
    table = evaluate(frames, classes=DET_CLASSES, metrics=("bev", "3d"))
    check(len(table) == 3 * 2 * 3 and all(
        math.isfinite(v) and 0.0 <= v <= 100.0 for v in table.values()),
        f"KITTI table {table}")
    print(f"10d KITTI R40 on 10a's predictions ({len(frames)} frame, "
          f"{sum(len(f.det_names) for f in frames)} detections, "
          f"{sum(len(f.gt_names) for f in frames)} GT), "
          f"{time.perf_counter() - t0:.2f} s: {table}")


class _SamplerReplay:
    """Stands in for roi_detectors.sample_rois_for_rcnn: records the CPU
    model's samples, and gives the card's model the same ones (the two
    devices' generators draw other numbers)."""

    def __init__(self, original):
        self.original, self.record, self.replay = original, [], None

    def __call__(self, generator, cfg, rois, *args):
        if self.replay is None:
            out = self.original(generator, cfg, rois, *args)
            self.record.append(out)
            return out
        return {k: v.to(rois.device) for k, v in self.replay.pop(0).items()}


def _det_tiny():
    """10e: every ported family at the JAX tests' tiny configs, the card
    (kernels) against the CPU (plain versions), same weights and batch:
    the eval forward, predict with every box in the NMS (valid sets and
    labels equal), the training losses, every gradient and the new
    BatchNorm statistics."""
    import torch
    import multimodal_gar_tpu_torch.detection.roi_detectors as roi_det
    from multimodal_gar_tpu_torch.detection import build_detector
    from multimodal_gar_tpu_torch.utils.testing import (
        PVPP_CANCELLED_BIASES, SECOND_SLICE, tiny_det_batch,
        tiny_detector_config, tiny_roi_config, tiny_second_slice_detector)

    def build(name, device):
        gen = torch.Generator().manual_seed(0)
        if name in SECOND_SLICE:
            return tiny_second_slice_detector(name, device=device,
                                              generator=gen)
        if name == "VoxelRCNN-Det":
            return roi_det.VoxelRCNNDetector(
                tiny_detector_config("SECOND"), tiny_roi_config(),
                device=device, generator=gen)
        return build_detector(name, tiny_detector_config(name),
                              device=device, generator=gen)

    original = roi_det.sample_rois_for_rcnn
    lines = []
    try:
        for name in ("SECOND", "PointPillar", "CenterPoint",
                     "VoxelRCNN-Det") + SECOND_SLICE:
            replay = _SamplerReplay(original)
            roi_det.sample_rois_for_rcnn = replay
            first = build(name, "cpu")
            state = {k: v.clone() for k, v in first.state_dict().items()}
            batch = tiny_det_batch(first.cfg, rulebook="Pillar" not in name,
                                   points=96 if name in SECOND_SLICE else 0)
            runs = []
            for device in ("cpu", DEVICE):
                model = build(name, device)
                model.load_state_dict(state)        # before any forward
                if device != "cpu":
                    replay.replay = list(replay.record)
                b = batch.to(device)
                # every box into the NMS: random weights score below the
                # tiny configs' threshold
                model.cfg = dataclasses.replace(model.cfg, nms=dataclasses
                                                .replace(model.cfg.nms,
                                                         score_thresh=0.0))
                with torch.no_grad():
                    preds = model.eval()(b)
                    out = model.predict(preds)
                model.train()
                losses = model.loss(model(b), b)
                losses["loss"].backward()
                runs.append({"model": model, "preds": preds, "out": out,
                             "losses": losses})
            cpu, card = runs
            noise = PVPP_CANCELLED_BIASES if name == "PV-RCNN++" else ()
            worst, n = 0.0, 0
            pairs = [(f"eval {k}", t, dict(_det_outputs(cpu["preds"]))[k])
                     for k, t in _det_outputs(card["preds"])
                     if t.is_floating_point()]
            pairs += [(f"loss {k}", v, cpu["losses"][k])
                      for k, v in card["losses"].items()]
            cp = dict(cpu["model"].named_parameters())
            pairs += [(f"grad {k}", p.grad, cp[k].grad)
                      for k, p in card["model"].named_parameters()
                      if cp[k].grad is not None and k not in noise]
            largest = max(float(p.grad.abs().max()) for p in cp.values()
                          if p.grad is not None)
            for k in noise:             # zero in exact arithmetic
                for side in (card["model"].get_parameter(k).grad.cpu(),
                             cp[k].grad):
                    check(float(side.abs().max()) <= NOISE_TOL * largest,
                          f"10e {name} grad {k}: not noise")
            cb = dict(cpu["model"].named_buffers())
            pairs += [(f"stat {k}", t, cb[k])
                      for k, t in card["model"].named_buffers()]
            for what, got, ref in pairs:
                _, rel = rel_err(got.detach().cpu(), ref.detach())
                check(rel <= MODEL_TOL, f"10e {name} {what}: rel err {rel}")
                worst, n = max(worst, rel), n + 1
            for k in ("valid", "labels"):
                check(torch.equal(card["out"][k].cpu(), cpu["out"][k]),
                      f"10e {name}: predict {k} differ")
            lines.append(f"{name}: {n} tensors, max rel err {worst:.2e}, "
                         f"{int(cpu['out']['valid'].sum())} kept")
    finally:
        roi_det.sample_rois_for_rcnn = original
    print("10e tiny, card vs CPU (eval outputs, losses, gradients, new "
          "statistics; predict's valid sets and labels equal): "
          + "; ".join(lines))


def phase_detectors() -> tuple:
    """Phase 10: the detector zoo's first slice. Each full-width path
    (10a-10c) reads the launch counts from 0; returns their sum and the
    worst (abs, rel) error of each sparse kernel against its plain version
    at the detectors' shapes."""
    counts, out, batch, errs = timed("10a SECOND", _det_second)
    rcnn_counts, rcnn_errs = timed("10b VoxelRCNN-Det", _det_voxelrcnn)
    paths = (counts, rcnn_counts,
             timed("10c PointPillar, PillarNet, CenterPoint", _det_others))
    timed("10d KITTI R40 eval", _det_eval, out, batch)
    timed("10e tiny detectors, card vs CPU", _det_tiny)
    return ({k: sum(c[k] for c in paths) for k in paths[0]},
            _worst(errs, rcnn_errs))


# ---------------------------------------------------------------------------
# phase 11: the detector zoo's second slice
# ---------------------------------------------------------------------------

# (K3 per b1 request, K3 and K4 per b2 train step) of each family at its
# default config: the trunk's VoxelBackbone8x (11 layers; the data gradient
# skips conv_input); UNetV2, its encoder's 11 and its decoder's 16 (4 UR
# blocks of a residual block's 2, the merge and the inverse conv or
# up_out1); VoxelNeXt's residual encoder to stride 32 (30) and shared_conv;
# PointRCNN has no sparse conv
SLICE2_LAUNCHES = {"PVRCNN": (11, 21, 11), "SECONDNetIoU": (11, 21, 11),
                   "PartA2": (27, 53, 27), "PointRCNN": (0, 0, 0),
                   "VoxelNeXt": (31, 61, 31), "PV-RCNN++": (11, 21, 11)}


def _timed_calls(patches, fn):
    """fn() with each (label, owner, attribute) callable wrapped in a pair
    of CUDA events; returns (fn's output, {label: [ms of each call]})."""
    import torch
    times, saved = {}, []

    def wrap(label, call):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call(*args, **kwargs)
            end.record()
            end.synchronize()
            times.setdefault(label, []).append(
                round(start.elapsed_time(end), 3))
            return out
        return run
    for label, owner, attr in patches:
        saved.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, wrap(label, getattr(owner, attr)))
    try:
        out = fn()
    finally:
        for owner, attr, old in reversed(saved):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
    return out, times


def _slice2_split(name, model, batch) -> dict:
    """ms by CUDA events of the stages of one request (after warm-up)."""
    import torch
    import multimodal_gar_tpu_torch.detection.pfe as pfe
    import multimodal_gar_tpu_torch.detection.point_rcnn as prcnn
    import multimodal_gar_tpu_torch.detection.pointnet2 as pn2
    import multimodal_gar_tpu_torch.detection.roi_detectors as roi_det
    nms = [("predict NMS", roi_det, "post_processing")]
    if name == "PVRCNN":
        patches = [("trunk + RPN head", model.trunk, "forward"),
                   ("FPS", pfe, "farthest_point_sampling"),
                   ("VSA (FPS included)", model.pfe, "forward"),
                   ("proposals + NMS", roi_det, "proposal_layer"),
                   ("RoI grid pool", model.roi_grid_pool, "forward"),
                   ("refinement", model.rcnn_head, "forward")] + nms
    else:
        patches = [("PointNet++", model.backbone_3d, "forward"),
                   ("FPS per SA level", pn2, "farthest_point_sampling"),
                   ("ball query per scale", pn2, "ball_query"),
                   ("proposal NMS", prcnn, "proposal_layer"),
                   ("RoI pool + SA encoder", model, "_roi_features")] + nms
    model.eval()

    def request():
        with torch.no_grad():
            return model.predict(model(batch))
    (_, total), times = _timed_calls(patches,
                                     lambda: _event_ms(request))
    return {"request": round(total, 3), **times}


def _parta2_x_window(model) -> None:
    """11a: PartA2 with ``x_window``: its UNetV2 encoder on the x-window
    kernel (11 launches per request), the decoder's 16 layers on K3 in the
    encoder's key-sorted row order; every output within MODEL_TOL of the
    nbr path's (the per-voxel ones through the rulebook's order_0),
    predict's valid sets and labels equal."""
    import torch
    batch = _det_batch("PartA2", [0], x_window=True)
    with torch.no_grad():
        ref = model.eval()(batch)
        ref_out = model.predict(ref)
    xw = _det_model("PartA2", x_window=True)
    xw.load_state_dict(model.state_dict())       # the trained weights
    want = {"subm_conv": 16, "window_conv": 11, "sparse_wgrad": 0}
    preds, out, ms, _ = _serve(xw, batch, want, "PartA2 x-window")
    order = batch.rulebook["order_0"].long()
    per_voxel = {"seg_logits", "part_reg", "voxel_centers", "voxel_valid"}
    got, worst = dict(_det_outputs(preds)), 0.0
    for name, t in _det_outputs(ref):
        if name in per_voxel:
            idx = order.reshape(order.shape + (1,) * (t.ndim - 2))
            t = torch.gather(t, 1, idx.expand(order.shape + t.shape[2:]))
        if not t.is_floating_point():
            check(torch.equal(got[name], t), f"PartA2 x-window {name}")
            continue
        _, rel = rel_err(got[name], t)
        check(rel <= MODEL_TOL, f"PartA2 x-window {name}: rel err {rel}")
        worst = max(worst, rel)
    check(torch.equal(out["valid"], ref_out["valid"])
          and torch.equal(out["labels"], ref_out["labels"]),
          "PartA2 x-window predict differs from the nbr path's")
    print(f"11a PartA2 x-window: requests {[round(t, 2) for t in ms]} ms, "
          f"launches per request {want}; outputs vs the nbr path max rel "
          f"err {worst:.3e}, predict's valid sets and labels equal")
    del xw


def _slice2_family(name: str):
    """11a: ``name`` at its default config, 3 requests at b1 and 4 train
    steps at b2; returns (launch counts, model, the b1 and b2 batches)."""
    import torch
    batch = _det_batch(name, [0])
    model = _det_model(name)
    k3, k3_step, k4_step = SLICE2_LAUNCHES[name]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    want = {"subm_conv": k3, "window_conv": 0, "sparse_wgrad": 0}
    preds, out, req_ms, post_ms = _serve(model, batch, want, name)
    _check_predict(out, 1, out["boxes"].shape[1], name)
    peak = _peak_gib()
    batch2 = _det_batch(name, [0, 1])
    want_step = {"subm_conv": k3_step, "window_conv": 0,
                 "sparse_wgrad": k4_step}
    times, loss = _train(model, batch2, want_step, name)
    step_peak = _peak_gib()
    if name == "PartA2":
        _parta2_x_window(model)
    counts = _counts()
    what = {"rois": "RoIs", "keypoints": "keypoints", "bev_valid": "BEV "
            "voxels"}
    sizes = {what[k]: int(v.sum()) if k == "bev_valid" else v.shape[1]
             for k, v in preds.items() if k in what}
    print(f"11a {name}: requests {[round(t, 2) for t in req_ms]} ms by "
          f"CUDA events (predict {[round(t, 2) for t in post_ms]}), peak "
          f"{peak:.2f} GiB, {sizes}, {int(batch.voxel_valid.sum())} voxels, "
          f"{int(batch.point_valid.sum())} points; train steps at b2 "
          f"{[round(t, 2) for t in times]} ms, last loss {loss:.4f}, peak "
          f"{step_peak:.2f} GiB; launches per request {want}, per step "
          f"{want_step}")
    if name in ("PVRCNN", "PointRCNN"):
        print(f"11a {name} request by stage, ms by CUDA events: "
              f"{_slice2_split(name, model, batch)}")
    return counts, model, batch, batch2


def phase_second_slice() -> tuple:
    """Phase 11: the detector zoo's second slice. Each family's full-width
    run (11a) reads the launch counts from 0; returns their sum and the
    worst (abs, rel) error of K3 and K4 against their plain versions at
    the new layers' shapes (11b). The tiny card-vs-CPU check (11c) runs
    with 10e."""
    import torch
    from multimodal_gar_tpu_torch.utils.testing import SECOND_SLICE
    total, keep = None, {}
    for name in SECOND_SLICE:
        counts, model, batch, batch2 = timed(f"11a {name}", _slice2_family,
                                             name)
        total = counts if total is None else {k: total[k] + v
                                              for k, v in counts.items()}
        if name in ("PartA2", "VoxelNeXt"):
            keep[name] = (model, batch, batch2)
        else:
            del model
        torch.cuda.empty_cache()
    (pa, pa1, pa2), (vn, _, vn2) = keep["PartA2"], keep["VoxelNeXt"]
    req, step = SLICE2_LAUNCHES["PartA2"][0], SLICE2_LAUNCHES["PartA2"][1:]
    _, vn_k3, vn_k4 = SLICE2_LAUNCHES["VoxelNeXt"]
    errs = timed("11b kernels at the new shapes", _det_kernel_checks,
                 [(pa, pa1, False), (pa, pa2, True), (vn, vn2, True)],
                 {"subm_conv": req + step[0] + vn_k3, "window_conv": 0,
                  "sparse_wgrad": step[1] + vn_k4},
                 "11b PartA2 (a request, a step at batch 2) and VoxelNeXt "
                 "(a step at batch 2)")
    return total, errs


# ---------------------------------------------------------------------------
# phase 12: CaDDN, MPPNet / MPPNetE2E, the zoo's extras, the 2D backbones
# ---------------------------------------------------------------------------

# a KITTI-like calibration: the rectified left colour camera's projection
# (P2), the velodyne-to-camera transform and the rectifying rotation of a
# KITTI object training frame
KITTI_P2 = ((721.5377, 0.0, 609.5593, 44.85728),
            (0.0, 721.5377, 172.854, 0.2163791),
            (0.0, 0.0, 1.0, 0.002745884))
KITTI_VELO_TO_CAM = ((7.533745e-03, -9.999714e-01, -6.166020e-04,
                      -4.069766e-03),
                     (1.480249e-02, 7.280733e-04, -9.998902e-01,
                      -7.631618e-02),
                     (9.998621e-01, 7.523790e-03, 1.480755e-02,
                      -2.717806e-01))
KITTI_R0_RECT = ((9.999239e-01, 9.837760e-03, -7.445048e-03),
                 (-9.869795e-03, 9.999421e-01, -4.278459e-03),
                 (7.402527e-03, 4.351614e-03, 9.999631e-01))
KITTI_IMAGE = (375, 1242)
# pcdet tools/cfgs/waymo_models/mppnet_4frames.yaml's head widths (its
# TRANS_INPUT 256, 3 encoder layers, 4 heads, 4 groups, 4^3 proxies, 128
# points per RoI, pool radii 0.8 / 1.6 with 16 samples each)
MPPNET_4FRAMES = dict(num_frames=4, num_groups=4, points_per_roi=128,
                      proxy_grid=4, hidden=256, num_heads=4, num_layers=3,
                      pool_radii=(0.8, 1.6), pool_nsamples=(16, 16))
NO_KERNEL = {"subm_conv": 0, "window_conv": 0, "sparse_wgrad": 0}
# 12c's dense inputs: BaseBEVBackboneV1's two maps (its defaults' widths
# at PointPillar's stride-2 and stride-4 grids) and SECOND's BEV map
V1_MAPS = ((128, 248, 216), (256, 124, 108))
MULTI_BEV = (512, 200, 176)


def _kitti_lidar_to_cam():
    import numpy as np
    l2c = np.eye(4, dtype=np.float32)
    l2c[:3] = np.asarray(KITTI_VELO_TO_CAM, np.float32)
    r0 = np.eye(4, dtype=np.float32)
    r0[:3, :3] = np.asarray(KITTI_R0_RECT, np.float32)
    return r0 @ l2c


def _caddn_batch(indices):
    """The synthetic KITTI frames at CaDDN's range as a DetBatch on the
    card, with a 375 x 1242 image per frame (seeded noise), the KITTI-like
    calibration and a depth map: each frame's points projected into the
    image, the nearest depth per pixel, 0 where no point falls."""
    import numpy as np
    import torch
    frames = _kitti_frames("CaDDN")
    batch = _det_batch("CaDDN", indices)
    l2c = _kitti_lidar_to_cam()
    p2 = np.asarray(KITTI_P2, np.float32)
    h, w = KITTI_IMAGE
    images, depths = [], []
    for i in indices:
        xyz = frames.frame(i)["points"][:, :3]
        cam = xyz @ l2c[:3, :3].T + l2c[:3, 3]
        img = np.concatenate([cam, np.ones_like(cam[:, :1])], 1) @ p2.T
        z = img[:, 2]
        u = np.floor(img[:, 0] / np.maximum(z, 1e-6)).astype(np.int64)
        v = np.floor(img[:, 1] / np.maximum(z, 1e-6)).astype(np.int64)
        ok = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        order = np.argsort(-z[ok])              # the nearest written last
        dm = np.zeros((h, w), np.float32)
        dm[v[ok][order], u[ok][order]] = z[ok][order]
        depths.append(dm)
        images.append(np.random.default_rng([7, i]).uniform(
            0, 1, (h, w, 3)).astype(np.float32))
    n = len(indices)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    return dataclasses.replace(
        batch, images=t(np.stack(images)),
        lidar_to_cam=t(np.repeat(l2c[None], n, 0)),
        cam_to_img=t(np.repeat(p2[None], n, 0)), depth_maps=t(np.stack(depths)))


def _conv_flop(module) -> tuple:
    """Forward hooks on every Conv2d under ``module`` adding 2 x its
    multiply-adds to a counter; returns (counter dict, hook handles)."""
    import torch
    count = {"flop": 0.0}

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        count["flop"] += 2.0 * out.numel() * mod.in_channels \
            // mod.groups * kh * kw
    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, torch.nn.Conv2d)]
    return count, handles


def _caddn():
    """12a: CaDDN at CaDDN.yaml's widths with the DeepLabV3-ResNet101 DDN:
    3 b1 requests, 3 b2 steps (the first times cuDNN), a request by stage
    and the trunk's and ASPP's FLOPs beside their bound."""
    import torch
    import multimodal_gar_tpu_torch.detection.caddn as caddn_mod
    batch = _caddn_batch([0])
    model = _det_model("CaDDN")
    c = model.cfg
    check(c.grid_size == (280, 376, 25)
          and type(model.ffn).__name__ == "DeepLabV3DDN"
          and len(model.ffn.backbone.layers) == 4
          and model.ffn.backbone.layers[2] == 23,
          f"CaDDN geometry {c.grid_size} / its DDN")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    preds, out, req_ms, post_ms = _serve(model, batch, NO_KERNEL, "CaDDN")
    peak = _peak_gib()
    _check_predict(out, 1, c.nms.nms_post_maxsize, "CaDDN")
    check(tuple(preds["depth_logits"].shape) == (1, 94, 311, 81)
          and tuple(preds["cls_preds"].shape) == (1, 188, 140, 18),
          f"CaDDN outputs {tuple(preds['depth_logits'].shape)} "
          f"{tuple(preds['cls_preds'].shape)}")
    trunk, th = _conv_flop(model.ffn.backbone)
    ddn, dh = _conv_flop(model.ffn)
    model.eval()

    def request():
        with torch.no_grad():
            return model.predict(model(batch))
    patches = [("DDN trunk (ResNet101)", model.ffn.backbone, "forward"),
               ("DDN (trunk, ASPP, classifier, upsample)", model.ffn,
                "forward"),
               ("frustum (DDN, channel reduce, outer product)", model,
                "image_features"),
               ("frustum to voxel", model, "voxel_features"),
               ("collapse", model.map_to_bev, "forward"),
               ("BEV trunk", model.backbone_2d, "forward"),
               ("head", model.dense_head, "forward"),
               ("NMS post-processing", caddn_mod, "post_processing")]
    (_, total), split = _timed_calls(patches, lambda: _event_ms(request))
    for h in th + dh:
        h.remove()
    t_ms = split["DDN trunk (ResNet101)"][0]
    t_bound = trunk["flop"] / PEAK_F32_FLOPS * 1e3
    d_bound = ddn["flop"] / PEAK_F32_FLOPS * 1e3
    print(f"12a CaDDN (grid 280 x 376 x 25, DeepLabV3-ResNet101 at "
          f"{KITTI_IMAGE[0]} x {KITTI_IMAGE[1]}, frustum 94 x 311 x 80 x "
          f"64): requests {[round(t, 2) for t in req_ms]} ms by CUDA events "
          f"(predict {[round(t, 2) for t in post_ms]}), peak {peak:.2f} GiB"
          f" after the warm-up; launches per request {NO_KERNEL}")
    print(f"12a CaDDN request by stage, ms by CUDA events (total "
          f"{total:.2f}): {split}")
    print(f"12a CaDDN DDN: trunk {trunk['flop']:.3e} FLOP, bound "
          f"{t_bound:.2f} ms at 67 TFLOP/s f32 against {t_ms:.2f} ms "
          f"({t_bound / t_ms:.0%}); trunk + ASPP + classifier "
          f"{ddn['flop']:.3e} FLOP, bound {d_bound:.2f} ms against "
          f"{split['DDN (trunk, ASPP, classifier, upsample)'][0]:.2f} ms")
    batch2 = _caddn_batch([0, 1])
    _reset_counts()
    times, loss = _train(model, batch2, NO_KERNEL, "CaDDN", steps=3)
    print(f"12a CaDDN train, batch 2: steps {[round(t, 2) for t in times]} "
          f"ms by CUDA events (the first times cuDNN), last loss "
          f"{loss:.4f}, peak {_peak_gib():.2f} GiB after the first")
    del model
    torch.cuda.empty_cache()
    return _counts()


def _mppnet_frames(b: int, frames: int, r: int = 128, n: int = 150000,
                   seed: int = 0, start: int = 0):
    """Synthetic Waymo-like sequences on the card: ``r`` objects per item
    moving at their velocity (10 Hz) over frames start .. start + frames -
    1, each frame's ``n`` points (half inside the boxes, half scattered
    over +-75 m), the boxes (C = 9), most recent first. Columns 7:9 hold
    what generate_trajectory adds to a frame's box to guess the earlier
    frame's: the displacement back by one frame."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, device=DEVICE, generator=gen) * (hi - lo) \
            + lo
    base = torch.cat([u(b, r, 2, lo=-60, hi=60), u(b, r, 1, lo=-1, hi=1),
                      torch.tensor([4.5, 2.0, 1.7], device=DEVICE)
                      * u(b, r, 3, lo=0.8, hi=1.2),
                      u(b, r, 1, lo=-3.1416, hi=3.1416),
                      torch.zeros((b, r, 2), device=DEVICE)], -1)
    vel = torch.randn((b, r, 2), device=DEVICE, generator=gen)   # m/s
    base[..., 7:9] = -0.1 * vel
    boxes, points = [], []
    for f in range(start + frames - 1, start - 1, -1):
        bx = base.clone()
        bx[..., :2] += 0.1 * f * vel
        half = n // 2
        owner = torch.randint(0, r, (b, half), device=DEVICE, generator=gen)
        own = torch.gather(bx, 1, owner[..., None].expand(-1, -1, 9))
        local = (u(b, half, 3) - 0.5) * own[..., 3:6]
        c, s = torch.cos(own[..., 6]), torch.sin(own[..., 6])
        inside = torch.stack([local[..., 0] * c - local[..., 1] * s,
                              local[..., 0] * s + local[..., 1] * c,
                              local[..., 2]], -1) + own[..., :3]
        scatter = torch.cat([u(b, n - half, 2, lo=-75, hi=75),
                             u(b, n - half, 1, lo=-2, hi=2)], -1)
        xyz = torch.cat([inside, scatter], 1)
        points.append(torch.cat([xyz, u(b, n, 1)], -1))
        boxes.append(bx)
    return torch.stack(points, 1), torch.stack(boxes, 1)     # (B, T, ...)


def _mppnet():
    """12b: MPPNet at mppnet_4frames.yaml's head widths on 4 frames of
    150,000 points with 128 trajectories: 3 b1 requests, 3 b2 steps
    (forward, loss, backward, clipped AdamW), ``generate_trajectory`` and
    an online MPPNetE2E sequence of 8 frames."""
    import torch
    from multimodal_gar_tpu_torch.detection.mppnet import (
        MPPNetConfig, MPPNetDetector, MPPNetE2EDetector, generate_trajectory)
    mp = MPPNetConfig(**MPPNET_4FRAMES)
    # the registry builds the default MPPNet; the phase runs the yaml's
    # widths, through the detector's own constructor
    cfg = _det_model("MPPNet").cfg
    model = MPPNetDetector(cfg, mp, device=DEVICE,
                           generator=torch.Generator().manual_seed(0))
    n_par = sum(p.numel() for p in model.parameters())

    def inputs(b, seed):
        pts, boxes = _mppnet_frames(b, 4, seed=seed)
        rois = boxes[..., :7].contiguous()
        pv = torch.ones(pts.shape[:3], dtype=torch.bool, device=DEVICE)
        rv = torch.ones(rois.shape[0], rois.shape[2], dtype=torch.bool,
                        device=DEVICE)
        gt = rois[:, 0, :64].clone()
        gt[..., :2] += 0.3
        labels = torch.ones(rv.shape, dtype=torch.int32, device=DEVICE)
        return pts, pv, rois, rv, gt, labels

    pts, pv, rois, rv, _, labels = inputs(1, 0)
    model.eval()

    def request():
        with torch.no_grad():
            preds = model(pts, pv, rois, rv)
            return preds, model.predict(dict(preds, roi_labels=labels))
    request()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    req_ms = []
    for _ in range(3):
        (preds, out), ms = _event_ms(request)
        req_ms.append(ms)
    check(_counts() == {**_counts(), **NO_KERNEL}, "MPPNet launched a kernel")
    peak = _peak_gib()
    _check_predict(out, 1, out["boxes"].shape[1], "MPPNet")
    check(all(torch.isfinite(t).all() for _, t in _det_outputs(preds)
              if t.is_floating_point()), "MPPNet outputs not finite")

    pts2, pv2, rois2, rv2, gt2, _ = inputs(2, 1)
    gtc = torch.ones(gt2.shape[:2], dtype=torch.int32, device=DEVICE)
    gtv = torch.ones(gt2.shape[:2], dtype=torch.bool, device=DEVICE)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    model.train()

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(model(pts2, pv2, rois2, rv2), gt2, gtc,
                          gtv)["loss"]
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 10.0)
        opt.step()
        return loss
    step_ms = []
    for i in range(3):
        loss, ms = _event_ms(step)
        check(torch.isfinite(loss), f"MPPNet step {i}: loss {loss}")
        step_ms.append(ms)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
    step_peak = _peak_gib()
    print(f"12b MPPNet (hidden 256, 3 layers, 4 heads, 4 groups, 4^3 "
          f"proxies, 128 points per RoI; {n_par} parameters; 4 frames of "
          f"150,000 points, 128 trajectories): requests "
          f"{[round(t, 2) for t in req_ms]} ms by CUDA events, peak "
          f"{peak:.2f} GiB; train steps at b2 {[round(t, 2) for t in step_ms]}"
          f" ms (the first warms up), last loss {loss.item():.4f}, peak "
          f"{step_peak:.2f} GiB; no sparse kernel")

    # the online E2E path on the offline model's weights: 8 frames, each
    # cropping its own points only, the trajectory linked by
    # generate_trajectory from the earlier frames' proposals
    e2e = MPPNetE2EDetector(cfg, mp, device=DEVICE,
                            generator=torch.Generator().manual_seed(1))
    e2e.load_state_dict(model.state_dict())
    e2e.eval()
    seq_pts, seq_boxes = _mppnet_frames(1, 8, seed=2)
    seq_pts, seq_boxes = seq_pts.flip(1), seq_boxes.flip(1)   # oldest first
    far = seq_boxes[0, 0].clone()
    far[:, :2] += 1000.0                        # no proposal yet: unmatched
    memory = memory_valid = None
    frame_ms, link_ms = [], []
    rv1 = torch.ones((1, 1, seq_boxes.shape[2]), dtype=torch.bool,
                     device=DEVICE)
    with torch.no_grad():
        for f in range(8):
            cur = seq_boxes[0, f]
            prev = torch.stack([seq_boxes[0, f - k] if f - k >= 0 else far
                                for k in (1, 2, 3)])
            (traj, tvalid), ms = _event_ms(
                lambda: generate_trajectory(cur, prev))
            link_ms.append(ms)
            if memory_valid is not None:
                tvalid = tvalid & torch.cat([rv1, memory_valid], 1)[0]
            out_e, ms = _event_ms(lambda: e2e(
                seq_pts[:, f:f + 1],
                torch.ones((1, 1, seq_pts.shape[2]), dtype=torch.bool,
                           device=DEVICE),
                traj[None, ..., :7].contiguous(), rv1[:, 0], memory=memory,
                traj_valid=tvalid[None], memory_valid=memory_valid))
            memory, memory_valid = out_e["memory"], out_e["memory_valid"]
            frame_ms.append(ms)
            check(torch.isfinite(out_e["rcnn_reg"]).all(),
                  f"E2E frame {f} not finite")
    check(bool(memory_valid.all()), "the bank is not full after 8 frames")
    linked = int(tvalid[1:].sum())
    check(linked > 0, "generate_trajectory linked no earlier frame")
    print(f"12b MPPNetE2E online, 8 frames of 150,000 points, 128 "
          f"trajectories, b1: ms per frame by CUDA events "
          f"{[round(t, 2) for t in frame_ms]}; generate_trajectory (128 "
          f"boxes, 3 earlier frames of 128 proposals) "
          f"{[round(t, 2) for t in link_ms]} ms ({linked} of "
          f"{tvalid[1:].numel()} earlier entries linked at frame 7); bank "
          f"full after frame 3")
    del model, e2e
    torch.cuda.empty_cache()
    return _counts()


def _extras_inputs(indices):
    """Raw points of the synthetic KITTI frames (16,384 each, PointPillar's
    range) and a SECOND batch at the 16,000-voxel cap."""
    from multimodal_gar_tpu_torch.data.detbatch import assemble_det_batch
    from multimodal_gar_tpu_torch.detection.anchors import (
        KITTI_PILLAR_RANGE, KITTI_PILLAR_SIZE)
    from multimodal_gar_tpu_torch.utils.testing import SyntheticKittiFrames
    pillars = assemble_det_batch(
        SyntheticKittiFrames(KITTI_PILLAR_RANGE, seed=0), indices,
        KITTI_PILLAR_SIZE, 16000, device=DEVICE)
    return pillars, _det_batch("SECOND", indices)


def _extra_modules():
    """The extras at the phase's widths, weights from seed 0."""
    import torch
    from multimodal_gar_tpu_torch.detection import extras as ex
    from multimodal_gar_tpu_torch.detection.anchors import (
        KITTI_ANCHORS, KITTI_CLASS_NAMES, KITTI_PILLAR_RANGE,
        KITTI_PILLAR_SIZE, KITTI_POINT_CLOUD_RANGE)
    from multimodal_gar_tpu_torch.detection.dense_heads import (
        AnchorHeadConfig)
    kw = dict(device=DEVICE, generator=torch.Generator().manual_seed(0))
    return {
        "vfe": ex.DynamicPillarVFE((64,), KITTI_PILLAR_SIZE,
                                   KITTI_PILLAR_RANGE, max_pillars=16000,
                                   **kw),
        "res18": ex.PillarRes18Backbone(64, (32, 64, 128, 256),
                                        (16000, 16000, 8000, 4000), **kw),
        "v1": ex.BaseBEVBackboneV1(**kw),
        "multi": ex.AnchorHeadMulti(
            512, AnchorHeadConfig(num_class=1),
            (("Car",), ("Pedestrian", "Cyclist")), KITTI_ANCHORS,
            (1408, 1600), KITTI_POINT_CLOUD_RANGE, **kw),
        "focal": [ex.FocalSparseConv(ch, ch, cap // 2, **kw)
                  for ch, cap in ((16, 16000), (32, 16000), (64, 8000))],
        "classes": KITTI_CLASS_NAMES}


def _pillar_st(mods, pillars):
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
    feats, coords, valid = mods["vfe"](pillars.points, pillars.point_valid)
    return SparseTensor(feats, coords, valid, (1, 496, 432))


def _focal_inputs(batch):
    """x_conv1..3 of SECOND's VoxelBackbone8x (seed-0 weights) on
    ``batch``: the FocalSparseConvs' inputs (computed before the counts
    are reset)."""
    import torch
    from multimodal_gar_tpu_torch.detection.vfe import mean_vfe
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
    trunk = _det_model("SECOND").trunk.eval()
    with torch.no_grad():
        feats = mean_vfe(batch.voxels, batch.voxel_num_points) \
            * batch.voxel_valid[..., None]
        ms = trunk.backbone_3d(SparseTensor(
            feats, batch.voxel_coords, batch.voxel_valid,
            trunk.cfg.sparse_shape), batch.rulebook)
    return [ms[f"x_conv{k}"] for k in (1, 2, 3)]


def _extras_runs(mods, pillars, bev, maps, sbatch, focal_in, train: bool):
    """One pass of each extra (a request, or a step's forward and
    backward of the sum of its outputs' mean squares), each a callable
    returning a loss or its outputs: {name: fn}."""
    import torch
    gt = (sbatch.gt_boxes, sbatch.gt_classes, sbatch.gt_valid)

    def sq(*ts):
        return sum(t.square().mean() for t in ts)

    def res18():
        ms = mods["res18"](_pillar_st(mods, pillars))
        return sq(*(ms[k].features for k in sorted(ms)))

    def v1():
        return sq(mods["v1"](maps))

    def multi():
        preds = mods["multi"](bev)
        if train:
            return mods["multi"].loss(preds, *gt, mods["classes"])["rpn_loss"]
        return mods["multi"].decode(preds, mods["classes"])

    def focal():
        outs = []
        for layer, st in zip(mods["focal"], focal_in):
            if train:
                st = dataclasses.replace(
                    st, features=st.features.detach().requires_grad_())
            new, imp = layer(st)
            outs += [new.features, imp]
        return sq(*outs)
    runs = {"DynamicPillarVFE + PillarRes18Backbone": res18,
            "BaseBEVBackboneV1": v1, "AnchorHeadMulti": multi,
            "FocalSparseConv x3": focal}
    if not train:
        runs["DynamicPillarVFE"] = lambda: _pillar_st(mods, pillars)
    return runs


# K3 / K4 launches per b1 request and b2 step of 12c: PillarRes18Backbone
# 17 submanifold layers (conv_input + 8 residual blocks of 2; in a step
# also conv_input's data gradient, its input is the trainable VFE's), the
# FocalSparseConvs 2 each (the feature conv and the importance conv at
# D = 16; in a step their inputs take gradients too)
EXTRAS_LAUNCHES = {
    "DynamicPillarVFE + PillarRes18Backbone": ((17, 0), (34, 17)),
    "BaseBEVBackboneV1": ((0, 0), (0, 0)),
    "AnchorHeadMulti": ((0, 0), (0, 0)),
    "FocalSparseConv x3": ((6, 0), (12, 6)),
    "DynamicPillarVFE": ((0, 0), (0, 0))}


def _extras():
    """12c: each extra at the phase's widths, 3 b1 requests and 3 b2 steps
    (forward, backward of its outputs' mean squares, the first warming up),
    K3 / K4 launches per request and step as EXTRAS_LAUNCHES says.
    Returns (launch counts, the b2 step runs for 12d)."""
    import torch
    from multimodal_gar_tpu_torch.detection.bev import cudnn_autotuned
    mods = _extra_modules()
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    total = None
    step_runs = None
    for b in (1, 2):
        pillars, sbatch = _extras_inputs(list(range(b)))
        bev = torch.randn((b,) + MULTI_BEV, device=DEVICE, generator=gen)
        maps = [torch.randn((b,) + shape, device=DEVICE, generator=gen)
                for shape in V1_MAPS]
        focal_in = _focal_inputs(sbatch)
        train = b == 2
        runs = _extras_runs(mods, pillars, bev, maps, sbatch, focal_in,
                            train)
        for name, fn in runs.items():
            want_k3, want_k4 = EXTRAS_LAUNCHES[name][int(train)]
            for m in mods.values():
                for layer in (m if isinstance(m, list) else [m]):
                    if isinstance(layer, torch.nn.Module):
                        layer.train(train)

            def call():
                with cudnn_autotuned():
                    if not train:
                        with torch.no_grad():
                            return fn()
                    loss = fn()
                    loss.backward()
                    return loss
            call()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            times = []
            for _ in range(3):
                _, ms = _event_ms(call)
                times.append(ms)
            got = _counts()
            check((got["subm_conv"], got["sparse_wgrad"])
                  == (3 * want_k3, 3 * want_k4),
                  f"12c {name}: launches {got}, expected {want_k3} K3 and "
                  f"{want_k4} K4 a call")
            total = got if total is None else {
                k: total[k] + v for k, v in got.items()}
            print(f"12c {name}, {'b2 step' if train else 'b1 request'}: "
                  f"{[round(t, 2) for t in times]} ms by CUDA events, peak "
                  f"{_peak_gib():.2f} GiB, K3 {want_k3} / K4 {want_k4} a "
                  f"call")
        if not train:
            st = _pillar_st(mods, pillars)
            print(f"12c inputs: {int(pillars.point_valid.sum())} points, "
                  f"{int(st.valid.sum())} pillars; SECOND x_conv1..3 "
                  f"{[int(s.valid.sum()) for s in focal_in]} voxels")
        else:
            step_runs = (runs, mods)
    return total, step_runs


# 12g: the bf16 launches of one b1 request and of one b2 step of the bf16
# twin of 12c's PillarRes18Backbone (17 layers; in a step conv_input's
# data gradient too, on the trainable VFE's pillars) and three
# FocalSparseConvs (2 each)
EXTRAS_BF16_REQUEST = {"subm_conv_bf16": 23}
EXTRAS_BF16_STEP = {"subm_conv_bf16": 23, "subm_conv_dgrad_bf16": 23,
                    "sparse_wgrad_bf16": 23}


def _extras_bf16() -> dict:
    """12g: 12c's PillarRes18Backbone (32 / 64 / 128 / 256 channels on the
    64-wide VFE's pillars) and its three FocalSparseConvs at bf16, 12c's
    weights: 3 b1 requests and 3 b2 steps (forward, backward of the
    outputs' mean squares, after one warming up), each launching
    EXTRAS_BF16_REQUEST / EXTRAS_BF16_STEP and no float32 sparse kernel;
    every bf16 sparse launch of one b2 step replayed against its plain
    version, each new pair from a CUDA graph (_bf16_replay). Returns the
    launch counts of the requests and steps."""
    import torch
    import multimodal_gar_tpu_torch.ops.kernels.subm_conv as k3m
    from multimodal_gar_tpu_torch.detection import extras as ex
    from multimodal_gar_tpu_torch.detection.bev import cudnn_autotuned
    mods = _extra_modules()
    kw = dict(device=DEVICE, generator=torch.Generator().manual_seed(0),
              dtype=torch.bfloat16)
    res18 = ex.PillarRes18Backbone(64, (32, 64, 128, 256),
                                   (16000, 16000, 8000, 4000), **kw)
    res18.load_state_dict(mods["res18"].state_dict())
    focal = []
    for f32, (ch, cap) in zip(mods["focal"], ((16, 16000), (32, 16000),
                                              (64, 8000))):
        focal.append(ex.FocalSparseConv(ch, ch, cap // 2, **kw))
        focal[-1].load_state_dict(f32.state_dict())
    total = {k: 0 for k in _counts()}
    step_call = None
    for b in (1, 2):
        pillars, sbatch = _extras_inputs(list(range(b)))
        focal_in = _focal_inputs(sbatch)
        train = b == 2
        for m in [mods["vfe"], res18] + focal:
            m.train(train)

        def fn():
            ms = res18(_pillar_st(mods, pillars))
            outs = [ms[k].features for k in sorted(ms)]
            for layer, st in zip(focal, focal_in):
                if train:
                    st = dataclasses.replace(
                        st, features=st.features.detach().requires_grad_())
                new, imp = layer(st)
                outs += [new.features, imp]
            return sum(t.float().square().mean() for t in outs)

        def call():
            with cudnn_autotuned():
                if not train:
                    with torch.no_grad():
                        return fn()
                loss = fn()
                loss.backward()
                return loss
        call()
        torch.cuda.synchronize()
        _reset_counts()
        times = [_event_ms(call)[1] for _ in range(3)]
        got = _counts()
        want = EXTRAS_BF16_STEP if train else EXTRAS_BF16_REQUEST
        check({k: got[k] for k in want} == {k: 3 * n for k, n in
                                            want.items()}
              and got["subm_conv"] == got["sparse_wgrad"] == 0,
              f"12g {'b2 step' if train else 'b1 request'}: launches "
              f"{got}, expected {want} a call")
        total = {k: total[k] + v for k, v in got.items()}
        print(f"12g PillarRes18Backbone + 3 FocalSparseConvs at bf16, "
              f"{'b2 step' if train else 'b1 request'}: "
              f"{[round(t, 2) for t in times]} ms by CUDA events, "
              f"launches {want} a call")
        if train:
            step_call = call
    calls, kernels = _recorded_launches(step_call, dict(
        _sparse_sites(), subm_conv_dgrad_bf16=(
            k3m, "subm_conv_dgrad_bf16", k3m.subm_conv_dgrad_bf16_plain)))
    _bf16_replay(calls, kernels, "12g b2 step")
    return total


def _kernel_replay(step_runs) -> dict:
    """12d: every K3 and K4 launch of 12c's b2 steps recorded with its
    inputs, then each replayed through the kernel and its plain version at
    KERNEL_TOL, the instances added for this phase ((256, 256), (64, 16),
    (16, 64)) twice for equal bits, and each timed in a run of 20 replayed
    from a CUDA graph beside its bound. Returns {kernel: (max abs err, max
    rel err)}."""
    import torch
    runs, mods = step_runs
    for m in mods.values():
        for layer in (m if isinstance(m, list) else [m]):
            if isinstance(layer, torch.nn.Module):
                layer.train()

    def run():
        for name, fn in runs.items():
            if EXTRAS_LAUNCHES[name][1] != (0, 0):
                fn().backward()
    calls, kernels = _recorded_launches(run)
    want = {"subm_conv": sum(v[1][0] for v in EXTRAS_LAUNCHES.values()),
            "window_conv": 0,
            "sparse_wgrad": sum(v[1][1] for v in EXTRAS_LAUNCHES.values())}
    seen = {n: sum(c[0] == n for c in calls) for n in kernels}
    check(seen == want, f"12d: launches recorded {seen}, expected {want}")
    new = {(256, 256), (64, 16), (16, 64)}
    worst, per_pair = {}, {}
    with torch.no_grad():
        for i, (name, args) in enumerate(calls):
            kernel, plain = kernels[name]
            got = kernel(*args)
            err, rel = rel_err(got, plain(*args))
            check(rel <= KERNEL_TOL, f"12d {name} launch {i} "
                  f"{[tuple(a.shape) for a in args]} rel err {rel}")
            a, r = worst.get(name, (0.0, 0.0))
            worst[name] = (max(a, err), max(r, rel))
            if name == "subm_conv":
                table, idx, w = args
                c, d = w.shape[1:]
                moved = nbytes(table, idx, w) + idx.shape[0] \
                    * idx.shape[1] * d * 4
            else:
                table, idx, dout = args
                c, d = table.shape[-1], dout.shape[-1]
                moved = nbytes(table, idx, dout) + 27 * c * d * 4
            if (c, d) in new:
                check(torch.equal(kernel(*args), kernel(*args)),
                      f"12d {name} ({c}, {d}) launch {i}: two runs differ")
            ms = graph_ms(lambda: kernel(*args))
            taps = int((idx >= 0).sum())
            bnd = bound(2.0 * c * d * taps, moved)
            key = (name, c, d)
            s = per_pair.setdefault(key, [0, 0.0, 0.0, 0.0])
            s[0] += 1
            s[1] += ms
            s[2] += bnd["bound_ms"]
            s[3] = max(s[3], rel)
    for (name, c, d), (n, ms, bnd_ms, rel) in sorted(per_pair.items()):
        tag = " (new)" if (c, d) in new else ""
        print(f"12d {name} ({c}, {d}){tag}: {n} launches, {ms:.4f} ms "
              f"replayed from a CUDA graph (runs of 20), bound "
              f"{bnd_ms:.4f} ms ({bnd_ms / ms:.1%}), worst rel err "
              f"{rel:.3e}{', twice equal bits' if tag else ''}")
    print(f"12d every K3 / K4 launch of 12c's b2 steps ({seen}) against its"
          f" plain version on its own inputs, max (abs, rel) err "
          f"{ {k: (f'{a:.3e}', f'{r:.3e}') for k, (a, r) in worst.items()} }")
    return worst


def _phase12_tiny():
    """12e: each new family and module at its parity-test size, the card
    (kernels, cuDNN) against the CPU (plain versions), same weights and
    inputs (utils/testing.py: card_vs_cpu): eval outputs, and for the
    trainable ones the losses' gradients and new statistics, at
    MODEL_TOL."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from multimodal_gar_tpu_torch.detection import extras as ex
    from multimodal_gar_tpu_torch.detection.ddn_deeplab import DeepLabV3DDN
    from multimodal_gar_tpu_torch.detection.mppnet import (
        MPPNetConfig, MPPNetDetector, MPPNetE2EDetector)
    from multimodal_gar_tpu_torch.models import backbones2d as b2
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
    from multimodal_gar_tpu_torch.utils.testing import (
        TINY_MPPNET, card_vs_cpu, mppnet_inputs, sparse_input_numpy,
        tiny_caddn, tiny_caddn_batch, tiny_detector_config)
    x = mppnet_inputs()
    mp_args = [torch.from_numpy(x[k]) for k in ("fp", "pv", "rois", "rv")]
    f, c, v, shape = sparse_input_numpy(c=32)
    st = SparseTensor(*(torch.from_numpy(a) for a in (f, c, v)), shape)
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 33, 65, 3)).astype(np.float32))

    def gen():
        return torch.Generator().manual_seed(0)

    def mpp(cls):
        return lambda d: cls(tiny_detector_config("SECOND"), MPPNetConfig(
            **TINY_MPPNET), device=d, generator=gen())

    def mpp_loss(m, out, a):
        return m.loss(out, *(torch.from_numpy(x[k]).to(a[0].device)
                             for k in ("gt", "gtc", "gtv")))["loss"]

    cases = {
        "CaDDN": (lambda d: tiny_caddn(device=d, generator=gen()),
                  [tiny_caddn_batch(tiny_caddn(device="cpu",
                                               generator=gen()).cfg)],
                  lambda m, out, a: m.loss(out, a[0])["loss"]),
        "MPPNet": (mpp(MPPNetDetector), mp_args, mpp_loss),
        "MPPNetE2E": (mpp(MPPNetE2EDetector),
                      [mp_args[0][:, :1], mp_args[1][:, :1]] + mp_args[2:],
                      None),
        "DeepLabV3DDN (ResNet50)": (
            lambda d: DeepLabV3DDN(9, "ResNet50", device=d, generator=gen()),
            [img], None),
        "PillarRes18Backbone": (
            lambda d: ex.PillarRes18Backbone(32, (32, 64, 128, 256),
                                             (60, 30, 12, 4), device=d,
                                             generator=gen()),
            [st], lambda m, out, a: sum(o.features.square().mean()
                                        for o in out.values())),
        "FocalSparseConv": (
            lambda d: ex.FocalSparseConv(32, 32, 40, device=d,
                                         generator=gen()),
            [st], lambda m, out, a: out[0].features.square().mean()
            + out[1].square().mean()),
        "VGG16": (lambda d: b2.VGG16(device=d, generator=gen()),
                  [img[:, :32, :64]], None),
        "InceptionV3Features": (
            lambda d: b2.InceptionV3Features(device=d, generator=gen()),
            [F.pad(img, (0, 0, 0, 34, 0, 66))], None)}
    lines = []
    for name, (build, args, loss_fn) in cases.items():
        try:
            n, worst = card_vs_cpu(build, args, loss_fn, DEVICE, MODEL_TOL,
                                   NOISE_TOL)
        except AssertionError as e:
            raise RuntimeError(f"12e {name}: {e}") from e
        lines.append(f"{name}: {n} tensors, max rel err {worst:.2e}")
    print("12e tiny, card vs CPU (eval outputs; gradients and new "
          "statistics of the trainable ones): " + "; ".join(lines))


def _backbones2d():
    """12f: VGG16, VGG19 and InceptionV3Features at 224 x 224 and 299 x
    299, b8: ms by CUDA events (after cuDNN's timing) and peak GiB."""
    import torch
    from multimodal_gar_tpu_torch.detection.bev import cudnn_autotuned
    from multimodal_gar_tpu_torch.models import backbones2d as b2
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    lines = []
    for name in ("VGG16", "VGG19", "InceptionV3Features"):
        model = getattr(b2, name)(device=DEVICE,
                                  generator=torch.Generator().manual_seed(0))
        model.eval()
        for size in (224, 299):
            x = torch.rand((8, size, size, 3), device=DEVICE, generator=gen)

            def run():
                with torch.no_grad(), cudnn_autotuned():
                    return model(x)
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = [_event_ms(run)[1] for _ in range(3)]
            out = run()
            check(all(torch.isfinite(o).all() for o in out),
                  f"12f {name} not finite")
            lines.append(f"{name} {size}: {[round(t, 2) for t in times]} ms,"
                         f" peak {_peak_gib():.2f} GiB, out "
                         f"{[tuple(o.shape) for o in out]}")
        del model
    print("12f 2D backbones, b8, by CUDA events: " + "; ".join(lines))


def phase_model_side() -> tuple:
    """Phase 12: CaDDN (12a), MPPNet and MPPNetE2E (12b), the extras (12c)
    with their K3 / K4 launches replayed against the plain versions (12d),
    each new module card vs CPU at its test size (12e), the 2D backbones
    (12f), the extras' sparse modules at bf16 (12g). Each full-width path
    reads the launch counts from 0; returns their sum and the worst (abs,
    rel) error of K3 and K4 in 12d."""
    paths = [timed("12a CaDDN", _caddn), timed("12b MPPNet", _mppnet)]
    extras_counts, step_runs = timed("12c extras", _extras)
    paths.append(extras_counts)
    errs = timed("12d kernels at the new shapes", _kernel_replay, step_runs)
    timed("12e tiny, card vs CPU", _phase12_tiny)
    timed("12f 2D backbones", _backbones2d)
    paths.append(timed("12g extras at bf16", _extras_bf16))
    return {k: sum(c[k] for c in paths) for k in paths[0]}, errs


# ---------------------------------------------------------------------------
# phase 13: the dataset side, and a full-width nuScenes CenterPoint
# ---------------------------------------------------------------------------

NUSC_NBR = {"subm_conv": 11, "window_conv": 0, "sparse_wgrad": 0}
NUSC_XW = {"subm_conv": 0, "window_conv": 11, "sparse_wgrad": 0}
# K3: 11 forward + 10 data gradient (conv_input's features need none)
NUSC_STEP = {"subm_conv": 21, "window_conv": 0, "sparse_wgrad": 11}
# 13e: the JAX tests' trees of the other datasets, through the registry
OTHER_TREES = ("KittiDataset", "WaymoDataset", "LyftDataset", "ONCEDataset",
               "Argo2Dataset", "CustomDataset", "PandasetDataset")


def _nusc_data(root: str) -> dict:
    """13a: a nuScenes tree at full width (utils/testing.py:
    write_nuscenes_tree: 4 key frames of 10 sweeps of 34,720 points),
    built through the registry, and ``det_batches`` at b1 on the card
    (NUSCENES_VOXEL over NUSCENES_RANGE, 10 points per voxel, the 60,000
    voxel cap) timed per frame on the host clock, frame 0 split into
    reading, voxelizing, the rulebook and the upload; the voxels before
    the cap, the sites per stage and the sites the stage caps cut off."""
    import numpy as np
    import torch
    from multimodal_gar_tpu_torch.data.registry import (build_dataset,
                                                        det_batches)
    from multimodal_gar_tpu_torch.data.rulebook import build_rulebook
    from multimodal_gar_tpu_torch.data.voxelizer import Voxelizer
    from multimodal_gar_tpu_torch.ops.device_rulebook import device_rulebook
    from multimodal_gar_tpu_torch.utils.testing import (
        NUSCENES_MAX_POINTS_PER_VOXEL, NUSCENES_MAX_SWEEPS,
        nuscenes_centerpoint_config, write_nuscenes_tree)
    cfg = nuscenes_centerpoint_config()
    check(cfg.grid_size == (1024, 1024, 40)
          and cfg.sparse_shape == (41, 1024, 1024)
          and cfg.max_voxels_per_stage == (60000, 60000, 30000, 15000),
          f"nuScenes geometry {cfg.grid_size}, caps "
          f"{cfg.max_voxels_per_stage}")
    t0 = time.perf_counter()
    info = write_nuscenes_tree(root)
    write_s = time.perf_counter() - t0
    ds = build_dataset("NuScenesDataset", root=root, info_paths=[info],
                       max_sweeps=NUSCENES_MAX_SWEEPS,
                       point_cloud_range=cfg.point_cloud_range)
    cap = cfg.max_voxels_per_stage[0]
    args = (cfg.voxel_size, cap)
    kw = dict(max_points_per_voxel=NUSCENES_MAX_POINTS_PER_VOXEL)
    batches, frame_s = [], []
    it = det_batches(ds, 1, *args, shuffle=False, device="cuda", **kw)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        torch.cuda.synchronize()
        if batch is None:
            break
        frame_s.append(time.perf_counter() - t0)
        batches.append(batch)
    check(len(batches) == 4 and batches[0].voxels.is_cuda
          and tuple(batches[0].voxels.shape) == (1, cap, 10, 5),
          f"det_batches: {len(batches)} batches of "
          f"{tuple(batches[0].voxels.shape)}")
    # frame 0 piece by piece
    t0 = time.perf_counter()
    fr = ds.frame(0)
    read_s = time.perf_counter() - t0
    pts = fr["points"][:, :5]
    t0 = time.perf_counter()
    voxels, coords, _ = Voxelizer(cfg.voxel_size, ds.range,
                                  NUSCENES_MAX_POINTS_PER_VOXEL, cap)(pts)
    vox_s = time.perf_counter() - t0
    n = len(voxels)
    padded = np.full((cap, 3), -1, np.int32)
    padded[:n] = coords
    caps = cfg.max_voxels_per_stage
    t0 = time.perf_counter()
    rb = build_rulebook(padded, n, cfg.sparse_shape, caps, x_window=False)
    rb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_rulebook(padded, n, cfg.sparse_shape, caps, x_window=True)
    xw_s = time.perf_counter() - t0
    host = ds.det_batch([0], *args, **kw)
    t0 = time.perf_counter()
    host.to("cuda")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    upload = sum(nbytes(t) for t in [
        host.voxels, host.voxel_coords, host.voxel_num_points,
        host.voxel_valid, host.gt_boxes, host.gt_classes, host.gt_valid,
        host.points, host.point_valid, *host.rulebook.values()])
    # the voxels the frame occupies before the cap
    g = np.asarray(cfg.grid_size)
    c = np.floor((pts[:, :3] - ds.range[:3])
                 / np.asarray(cfg.voxel_size)).astype(np.int64)
    ok = np.all((c >= 0) & (c < g), axis=1)
    occupied = len(np.unique((c[ok, 2] * g[1] + c[ok, 1]) * g[0]
                             + c[ok, 0]))
    b0 = batches[0]
    maps = device_rulebook(b0.voxel_coords, b0.voxel_valid,
                           cfg.sparse_shape, caps)
    sites = [int(b0.voxel_valid.sum())] + [int(rb[f"count_{k}"])
                                           for k in (1, 2, 3)]
    cut = [max(occupied - cap, 0)] + [
        int(maps[f"dropped_{k}"][0]) for k in (1, 2, 3)]
    print(f"13a nuScenes tree: 4 frames x {NUSCENES_MAX_SWEEPS} sweeps of "
          f"34,720 points written in {write_s:.2f} s; {len(fr['points'])} "
          f"points in frame 0 (5 features, the time lag in the fifth); "
          f"det_batches at b1 onto the card: {[round(t, 3) for t in frame_s]}"
          f" s per frame on the host clock; frame 0 split: reading (10 "
          f"sweeps, transforms) {read_s:.3f} s, voxelizing {vox_s:.3f} s, "
          f"the rulebook {rb_s:.3f} s ({xw_s:.3f} s with the x-window maps),"
          f" the upload {up_s:.4f} s ({upload / 2 ** 20:.1f} MiB); voxels "
          f"{occupied} occupied, {sites[0]} kept; sites per stage {sites}, "
          f"cut off by the caps {caps}: {cut}")
    # the x-window maps of frame 0's voxels for 13b's x-window requests
    xw = build_rulebook(b0.voxel_coords[0].cpu().numpy(), sites[0],
                        cfg.sparse_shape, caps, x_window=True)
    xw_batch = dataclasses.replace(b0, rulebook={
        k: torch.from_numpy(v[None]).cuda() for k, v in xw.items()})
    check(all(torch.equal(xw_batch.rulebook[k], b0.rulebook[k])
              for k in b0.rulebook), "the x-window rulebook's nbr maps differ")

    def cat(x, y):
        if isinstance(x, dict):
            return {k: torch.cat([x[k], y[k]]) for k in x}
        return None if x is None else torch.cat([x, y])
    b2 = type(b0)(**{f.name: cat(getattr(b0, f.name),
                                 getattr(batches[1], f.name))
                     for f in dataclasses.fields(b0)})
    return dict(cfg=cfg, ds=ds, batch=b0, xw_batch=xw_batch, batch2=b2,
                frame_s=frame_s)


def _center_stages(model, batch) -> dict:
    """ms by CUDA events of each stage of one CenterPoint request (after
    warm-up): the sparse backbone, conv_out, the BEV scatter, the BEV
    backbone, the head, the heatmap decode and the class-agnostic NMS."""
    import torch
    from multimodal_gar_tpu_torch.detection.bev import (cudnn_autotuned,
                                                        sparse_to_dense_bev)
    from multimodal_gar_tpu_torch.detection.dense_heads import (
        decode_center_preds)
    from multimodal_gar_tpu_torch.detection.post import class_agnostic_nms
    from multimodal_gar_tpu_torch.detection.vfe import mean_vfe
    from multimodal_gar_tpu_torch.models.sparse_backbone import SparseTensor
    t, c, out = model.trunk, model.cfg, {}

    def stage(name, fn):
        res, ms = _event_ms(fn)
        out[name] = round(ms, 3)
        return res
    with torch.no_grad(), cudnn_autotuned():
        feats = mean_vfe(batch.voxels, batch.voxel_num_points) \
            * batch.voxel_valid[..., None]
        st = SparseTensor(feats, batch.voxel_coords, batch.voxel_valid,
                          c.sparse_shape)
        ms = stage("backbone_3d", lambda: t.backbone_3d(st, batch.rulebook))
        co = stage("conv_out", lambda: t.conv_out(ms["x_conv4"]))
        bev = stage("to_bev", lambda: sparse_to_dense_bev(co))
        bev2 = stage("backbone_2d", lambda: t.backbone_2d(bev))
        preds = stage("head", lambda: model.dense_head(bev2))
        scores, _, boxes = stage("decode", lambda: decode_center_preds(
            preds, c.center_head, c.grid_size, c.voxel_size,
            c.point_cloud_range, max_boxes=min(c.nms.nms_pre_maxsize, 500)))
        stage("nms", lambda: class_agnostic_nms(scores[0], boxes[0], c.nms))
    return out


def _nusc_requests(data: dict) -> tuple:
    """13b: CenterPoint at nuscenes_centerpoint_config (5 point features,
    weights from seed 0, through the detector registry): 3 b1 requests on
    the nbr-map path (K3 11 each), then 3 with ``x_window`` (window_conv 11,
    K3 0) whose outputs match the nbr path's; request ms by CUDA events,
    the peak after the warm-up."""
    import torch
    from multimodal_gar_tpu_torch.detection import build_detector
    cfg, batch = data["cfg"], data["batch"]
    model = build_detector("CenterPoint", cfg, in_channels=5, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    preds, out, req_ms, post_ms = _serve(model, batch, NUSC_NBR,
                                         "nuScenes CenterPoint")
    counts = _counts()
    peak = _peak_gib()
    stages = _center_stages(model, batch)
    check(tuple(preds["hm"].shape) == (1, 128, 128, 10),
          f"heatmap {tuple(preds['hm'].shape)}")
    _check_predict(out, 1, cfg.nms.nms_post_maxsize, "nuScenes CenterPoint")
    xw = build_detector("CenterPoint", dataclasses.replace(cfg, x_window=True),
                        in_channels=5, device="cuda")
    xw.load_state_dict(model.state_dict())
    _reset_counts()
    xpreds, xout, xms, _ = _serve(xw, data["xw_batch"], NUSC_XW,
                                  "nuScenes CenterPoint x-window")
    counts = {k: counts[k] + v for k, v in _counts().items()}
    refs = dict(_det_outputs(preds))
    worst = 0.0
    for name, t in _det_outputs(xpreds):
        _, rel = rel_err(t, refs[name])
        check(rel <= MODEL_TOL, f"13b x-window {name}: rel err {rel}")
        worst = max(worst, rel)
    check(torch.equal(xout["valid"], out["valid"])
          and torch.equal(xout["labels"], out["labels"]),
          "13b x-window predict differs from the nbr path's")
    host_s = statistics.median(data["frame_s"])
    print(f"13b nuScenes CenterPoint ({int(batch.voxel_valid.sum())} "
          f"voxels, a 128 x 128 x 10 heatmap): nbr-map requests "
          f"{[round(t, 2) for t in req_ms]} ms by CUDA events (predict "
          f"{[round(t, 2) for t in post_ms]} ms), {int(out['valid'].sum())}"
          f" boxes kept, peak {peak:.2f} GiB after the warm-up; launches per"
          f" request {NUSC_NBR}; x-window requests "
          f"{[round(t, 2) for t in xms]} ms, launches {NUSC_XW}, outputs vs "
          f"the nbr path max rel err {worst:.3e}, valid sets and labels "
          f"equal; det_batches' host {host_s:.3f} s per frame is "
          f"{host_s * 1e3 / statistics.median(req_ms):.1f} times the "
          f"request's device time; a request by stage, ms by CUDA events: "
          f"{stages}")
    return model, xw, out, counts


def _nusc_train(model, batch2) -> dict:
    """13c: one warm-up b2 train step, then 3 (K3 21, K4 11 each)."""
    _reset_counts()
    times, loss = _train(model, batch2, NUSC_STEP, "nuScenes CenterPoint",
                         steps=4)
    counts = _counts()
    print(f"13c nuScenes CenterPoint train, b2: warm-up step "
          f"{times[0]:.1f} ms, then {[round(t, 2) for t in times[1:]]} ms by "
          f"CUDA events, last loss {loss:.4f}, peak {_peak_gib():.2f} GiB; "
          f"launches per step {NUSC_STEP}")
    return counts


def _nusc_kernels(model, xw, data) -> dict:
    """13d: every K3, window_conv and K4 launch of a 13b request on each
    path and a 13c step recorded with its inputs and replayed through the
    kernel and its plain version at KERNEL_TOL; each launch of the input
    layer (5 features, the (8, 16) instances on the zero-padded table)
    also twice for equal bits and timed replayed from a CUDA graph (runs
    of 20) beside its present-taps bound, with the bare (8, 16) kernel on
    a table padded beforehand and, for the other route, the (16, 16)
    instance on a table padded to 16. Returns {kernel: (max abs err, max
    rel err)}."""
    import torch
    import torch.nn.functional as F
    import multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad as k4m
    import multimodal_gar_tpu_torch.ops.kernels.subm_conv as k3m
    import multimodal_gar_tpu_torch.ops.kernels.window_conv as wcm
    from multimodal_gar_tpu_torch.utils.testing import window_taps

    def run():
        with torch.no_grad():
            model.eval()(data["batch"])
            xw.eval()(data["xw_batch"])
        model.train()
        batch2 = data["batch2"]
        model.loss(model(batch2), batch2)["loss"].backward()
        model.zero_grad(set_to_none=True)
    calls, kernels = _recorded_launches(run)
    want = {"subm_conv": 11 + 21, "window_conv": 11, "sparse_wgrad": 11}
    seen = {n: sum(c[0] == n for c in calls) for n in kernels}
    check(seen == want, f"13d: launches recorded {seen}, expected {want}")
    launch = {"subm_conv": k3m._launch, "window_conv": wcm._launch,
              "sparse_wgrad": k4m._launch}
    worst, first = {}, 0
    with torch.no_grad():
        for i, (name, args) in enumerate(calls):
            kernel, plain = kernels[name]
            ref = plain(*args)
            err, rel = rel_err(kernel(*args), ref)
            check(rel <= KERNEL_TOL, f"13d {name} launch {i} "
                  f"{[tuple(a.shape) for a in args]} rel err {rel}")
            a, r = worst.get(name, (0.0, 0.0))
            worst[name] = (max(a, err), max(r, rel))
            table = args[0]
            if table.shape[-1] != 5:
                continue
            first += 1
            check(torch.equal(kernel(*args), kernel(*args)),
                  f"13d {name} launch {i}: two runs differ")
            b, r_ = args[1].shape[:2]
            if name == "sparse_wgrad":
                _, idx, dout = args
                d, taps = dout.shape[-1], int((idx >= 0).sum())
                moved = nbytes(table, idx, dout) + 27 * 5 * d * 4

                def padded(width):
                    t = F.pad(table, (0, width - 5))
                    return lambda: launch[name](t, idx, dout)
            else:
                _, maps, w = args
                d = w.shape[-1]
                taps = (window_taps(maps) if name == "window_conv"
                        else int((maps >= 0).sum()))
                moved = nbytes(table, maps, w) + b * r_ * d * 4

                def padded(width):
                    t = F.pad(table, (0, width - 5))
                    wp = F.pad(w, (0, 0, 0, width - 5))
                    return lambda: launch[name](t, maps, wp)
            alt = padded(16)()
            alt = alt[:, :5] if name == "sparse_wgrad" else alt
            _, alt_rel = rel_err(alt, ref)
            check(alt_rel <= KERNEL_TOL, f"13d {name}: the (16, 16) route "
                  f"rel err {alt_rel}")
            bnd = bound(2.0 * 5 * d * taps, moved)
            ms = graph_ms(lambda: kernel(*args))
            ms8, ms16 = graph_ms(padded(8)), graph_ms(padded(16))
            plain_ms = median_ms(lambda: plain(*args))
            print(f"13d {name} launch {i} (5 features, the (8, 16) "
                  f"instance, {tuple(table.shape)} table, {taps} taps "
                  f"present): {ms:.4f} ms replayed through the wrapper "
                  f"(pad included), bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']}, {bnd['bound_ms'] / ms:.1%}); the "
                  f"bare kernel {ms8:.4f} ms; padded to 16 on the (16, 16) "
                  f"instance {ms16:.4f} ms; the plain version {plain_ms:.4f}"
                  f" ms per call; rel err {rel:.3e}, twice equal bits")
    check(first == 4, f"13d: {first} input-layer launches, expected 4")
    print(f"13d every K3 / window_conv / K4 launch of 13b and 13c ({seen}) "
          f"against its plain version on its own inputs, max (abs, rel) err "
          f"{ {k: (f'{a:.3e}', f'{r:.3e}') for k, (a, r) in worst.items()} }")
    return worst


def _tree_config(ds):
    """Tiny SECOND at dataset ``ds``'s range, its BEV grid a multiple of
    16 cells (a voxel near 0.4 m) and 0.1 m in z, so that
    VoxelBackbone8x's stages and conv_out keep a layer of height."""
    from multimodal_gar_tpu_torch.utils.testing import tiny_detector_config
    rng = [float(v) for v in ds.range]
    ext = [rng[i + 3] - rng[i] for i in range(3)]
    voxel = tuple(e / (16 * max(1, round(e / 6.4))) for e in ext[:2]) + (0.1,)
    return dataclasses.replace(tiny_detector_config("SECOND"),
                               point_cloud_range=tuple(rng), voxel_size=voxel,
                               max_voxels_per_stage=(256, 256, 128, 64))


def _dataset_trees(root: str) -> None:
    """13e: at the JAX tests' sizes, card against CPU (utils/testing.py:
    card_vs_cpu): a tiny 5-feature CenterPoint on a nuScenes tree of the
    JAX test's size (eval outputs, losses, gradients, statistics); then
    every other dataset's test tree through the registry and det_batches
    onto the card and through a tiny SECOND at its point width (eval
    outputs; K3 11 on the card). PandaSet's tree needs pandas: where it
    does not import, the phase says so and leaves PandaSet out."""
    import importlib.util
    from multimodal_gar_tpu_torch.data.registry import (build_dataset,
                                                        det_batches)
    from multimodal_gar_tpu_torch.detection import build_detector
    from multimodal_gar_tpu_torch.utils.testing import (
        TINY_NUSCENES_RANGE, TINY_NUSCENES_TREE, TINY_NUSCENES_VOXEL,
        card_vs_cpu, nuscenes_centerpoint_config, write_dataset_tree,
        write_nuscenes_tree)
    nusc = os.path.join(root, "tiny_nuscenes")
    info = write_nuscenes_tree(nusc, point_cloud_range=TINY_NUSCENES_RANGE,
                               **TINY_NUSCENES_TREE)
    ds = build_dataset("NuScenesDataset", root=nusc, info_paths=[info],
                       max_sweeps=2, point_cloud_range=TINY_NUSCENES_RANGE)
    (batch,) = det_batches(ds, 2, TINY_NUSCENES_VOXEL, 256, shuffle=False,
                           device="cuda")
    check(batch.voxels.is_cuda and batch.voxels.shape[-1] == 5,
          "13e nuScenes batch")
    cfg = nuscenes_centerpoint_config(tiny=True)
    n, worst = card_vs_cpu(
        lambda dev: build_detector("CenterPoint", cfg, in_channels=5,
                                   device=dev), [batch.to("cpu")],
        loss_fn=lambda m, preds, a: m.loss(preds, a[0])["loss"])
    print(f"13e tiny CenterPoint at 5 features on the test-size nuScenes "
          f"tree, card vs CPU: {n} tensors, worst rel err {worst:.3e}")
    ran, left_out = [], []
    for name in OTHER_TREES:
        if name == "PandasetDataset" \
                and importlib.util.find_spec("pandas") is None:
            left_out.append(name)
            continue
        kwargs = write_dataset_tree(name, os.path.join(root, name))
        ds = build_dataset(name, **kwargs)
        cfg = _tree_config(ds)
        batches = list(det_batches(ds, 1, cfg.voxel_size, 256, shuffle=False,
                                   device="cuda", max_points=512, max_gt=8))
        check(len(batches) == len(ds) and all(b.voxels.is_cuda
                                              for b in batches),
              f"13e {name}: batches")
        width = batches[0].voxels.shape[-1]
        before = _counts()["subm_conv"]
        n, worst = card_vs_cpu(
            lambda dev: build_detector("SECOND", cfg, in_channels=width,
                                       device=dev), [batches[0].to("cpu")])
        k3 = _counts()["subm_conv"] - before
        check(k3 == 11, f"13e {name}: K3 launched {k3} times")
        ran.append(f"{name} ({len(batches)} frames, {width} features, "
                   f"{int(batches[0].voxel_valid.sum())} voxels, grid "
                   f"{cfg.grid_size}, {n} tensors, worst rel err "
                   f"{worst:.3e})")
    print(f"13e through the registry onto the card and a tiny SECOND, card "
          f"vs CPU: {'; '.join(ran)}; left out: {left_out or 'none'}")


def _nusc_eval(ds, out) -> None:
    """13f: the NDS evaluation (data/nuscenes.py: evaluation) of 13b's
    last predictions against frame 0's GT, host seconds."""
    names = ds.class_names
    v = out["valid"][0].cpu().numpy()
    annos = [{"token": ds.infos[0]["token"],
              "boxes_lidar": out["boxes"][0].cpu().numpy()[v],
              "score": out["scores"][0].cpu().numpy()[v],
              "name": [names[c - 1] for c in
                       out["labels"][0].cpu().numpy()[v]]}]
    t0 = time.perf_counter()
    table = ds.evaluation(annos, indices=[0])
    seconds = time.perf_counter() - t0
    check(all(math.isfinite(table[k]) and 0.0 <= table[k] <= 1.0
              for k in ("mean_ap", "nd_score")), f"NDS table {table}")
    print(f"13f NDS of 13b's predictions ({int(v.sum())} boxes, "
          f"{len(ds.infos[0]['gt_names'])} GT) in {seconds:.3f} s on the "
          f"host: mean AP {table['mean_ap']:.4f}, NDS "
          f"{table['nd_score']:.4f}, TP errors {table['tp_errors']}")


def _learning_checks() -> dict:
    """13g: the two learning checks on the card (utils/testing.py:
    overfit_mgar, overfit_second; tests/test_torch_overfit.py runs them on
    the CPU). MGAR starts from the port's own seed-0 init, the CPU twin
    from the JAX test's: the port's eval L_total starts lower than the JAX
    init's (11.9 against 19.1 on the CPU) above the same floor, which the
    pose term keeps near 1, so here the loss must fall 5 times, with the
    train-set grouping AP 1, within the JAX test's 800 steps."""
    from multimodal_gar_tpu_torch.utils.testing import (overfit_mgar,
                                                        overfit_second)
    _reset_counts()
    t0 = time.perf_counter()
    r = overfit_mgar(device="cuda", fall=5.0)
    mgar_s = time.perf_counter() - t0
    check(r["loss"] <= r["loss0"] / 5 and abs(r["group_ap"] - 1.0) < 1e-6,
          f"13g MGAR did not overfit: {r}")
    t0 = time.perf_counter()
    s = overfit_second(device="cuda")
    second_s = time.perf_counter() - t0
    check(math.isfinite(s["last"]) and s["last"] < s["first"] / 5.0
          and s["top_to_gt_m"] < 2.0 and s["top_score"] > 0.3,
          f"13g SECOND did not overfit: {s}")
    counts = _counts()
    print(f"13g learning checks on the card: MGAR at tiny_config, eval "
          f"L_total {r['loss0']:.4f} -> {r['loss']:.4f} in {r['steps']} "
          f"steps, {mgar_s:.1f} s, train-set group AP {r['group_ap']:.3f}; "
          f"SECOND on one scene, loss {s['first']:.4f} -> {s['last']:.4f} "
          f"in {s['steps']} steps, {second_s:.1f} s, top box "
          f"{s['top_to_gt_m']:.2f} m from a GT centre at score "
          f"{s['top_score']:.3f}; launches {counts}")
    return counts


def phase_datasets() -> tuple:
    """Phase 13: the nuScenes data path at full width (13a), CenterPoint
    requests on both sparse paths (13b) and b2 train steps (13c) on it,
    their kernel launches against the plain versions (13d), the datasets'
    test trees card vs CPU (13e), the NDS evaluation (13f) and the two
    learning checks (13g). Each full-width path reads the launch counts
    from 0; returns their sum and the worst (abs, rel) kernel errors."""
    with tempfile.TemporaryDirectory() as root:
        data = timed("13a nuScenes data", _nusc_data,
                     os.path.join(root, "nuscenes"))
        model, xw, out, counts = timed("13b nuScenes requests",
                                       _nusc_requests, data)
        paths = [counts, timed("13c nuScenes train steps", _nusc_train,
                               model, data["batch2"])]
        errs = timed("13d kernels at 5 features", _nusc_kernels, model, xw,
                     data)
        timed("13e dataset trees, card vs CPU", _dataset_trees, root)
        timed("13f NDS", _nusc_eval, data["ds"], out)
    paths.append(timed("13g learning checks", _learning_checks))
    return {k: sum(c[k] for c in paths) for k in paths[0]}, errs


# phase 14: the parallel layer. A b1 micro-step at the 16k training cap
# launches these (phase 6); each rank of 14b runs one at b1.
PAR_MICRO_STEP = {"stem_conv": 1, "window_conv": 11, "subm_conv": 10,
                  "sparse_wgrad": 11}
# 14a: the mesh path at world 1 against the step without one; the same
# float32 operations on one card, so bit for bit in practice
MESH_TOL = 1e-6
# 14b / 14c: two ranks against one process on the global batch: the
# batch statistics, loss counts and gradients summed in another order
PAR_TOL = 1e-4
PAR_LR = 1e-6
# where a leaf's float32 error is set by its conditioning, the ranks may
# differ from one process by this many times the spread of one process
# over the same batch in the other sample order (deterministic cuDNN, so
# summation order alone): the RGB non-local block's BatchNorm over 100
# near-equal attention averages; at b2 every leaf of SECOND's trunk
# behind its BatchNorms, 0.9e-3 to 3.6e-3, while its head's class weights
# agree to 2e-6 and the global gradient norm to 1.7e-5. PAR_FAULTS shows
# each fault the ranks could carry failing under these floors.
SPREAD_FACTOR = 10.0
# faults planted in 14b's and 14c's ranks (utils/parallel_testing.py:
# planted_fault), each of which must fail the comparison the real ranks
# pass: the comparison's own check. SECOND's losses normalise per sample,
# so a rank-local count changes nothing there.
PAR_FAULTS = {"step": ("bn_local", "local_counts", "no_grad_reduce"),
              "det": ("bn_local", "no_grad_reduce")}
INPUT_WIDTHS = tuple(range(9, 16))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _floored(rows) -> list:
    """check_leaves' leaves past the tolerance, printable: (leaf, relative
    error, share of the floor they passed within)."""
    return [(k, f"{e:.2e}", f"{q:.0%}") for k, e, q in rows]


def _par_world1(cfg16, fields16, backend: str = "nccl",
                device: str = "cuda") -> dict:
    """14a: a process group of one over NCCL (localhost, a free port), eight
    micro-steps at the 16k cap with accumulation 8 (one Adam update)
    through the mesh path, and the same eight without a mesh from the same
    seed: parameters, Adam moments, accumulator and BatchNorm statistics
    to MESH_TOL of each leaf's largest. Micro-step ms both ways by CUDA
    events; the gradient all-reduce's bytes per micro-step and its ms on
    parameter-shaped tensors."""
    import torch
    import torch.distributed as dist
    from multimodal_gar_tpu_torch.config import MeshConfig
    from multimodal_gar_tpu_torch.parallel.mesh import (all_reduce_grads,
                                                        make_mesh)
    from multimodal_gar_tpu_torch.utils.parallel_testing import (
        check_leaves, leaf_errors, mgar_steps)
    check(cfg16.train.grad_accum_steps == 8, "14a: accumulation 8 expected")
    kw = dict(cfg=cfg16, fields=fields16, steps=8, full_state=True,
              lr=cfg16.train.stages[0].learning_rate)
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(data=1, fsdp=1), device)
        _reset_counts()
        got = mgar_steps(mesh, device, **kw)
        counts = _counts()
        want = {k: 8 * n for k, n in PAR_MICRO_STEP.items()}
        check(all(counts[k] == n for k, n in want.items()),
              f"14a: launches {counts}, expected {want}")
        ref = mgar_steps(None, device, **kw)
        shapes = [t.shape for t in ref["optimizer"]["exp_avg"]]
        grads = [torch.randn(s, device=device) for s in shapes]
        reduce_ms = median_ms(lambda: all_reduce_grads(grads, mesh)) \
            if device == "cuda" else float("nan")
    finally:
        dist.destroy_process_group()
    check(got["optimizer"]["updates"] == ref["optimizer"]["updates"] == 1,
          "14a: one Adam update expected on each side")
    worst = check_leaves(leaf_errors(got["model"], ref["model"]), MESH_TOL,
                          "14a model")[0]
    for key in ("exp_avg", "exp_avg_sq", "acc"):
        worst = max(worst, check_leaves(leaf_errors(
            got["optimizer"][key], ref["optimizer"][key]), MESH_TOL,
            f"14a {key}")[0])
    for a, b in zip(got["metrics"], ref["metrics"]):
        check(abs(a["loss"] - b["loss"]) <= MESH_TOL * max(abs(b["loss"]),
                                                           1.0),
              f"14a: loss {a['loss']} against {b['loss']}")
    reduced = [c for c in got["collectives"] if c["op"] == "all_reduce"]
    grad_bytes = sum(c["bytes"] for c in reduced)
    check(grad_bytes >= got["param_bytes"],
          f"14a: all-reduce of {grad_bytes} B < {got['param_bytes']} B")
    steady = (statistics.median(got["ms"][1:7]),
              statistics.median(ref["ms"][1:7]))
    print(f"14a world 1 over {backend}: 8 micro-steps (accumulation 8) "
          f"through the mesh path equal the steps without one (worst leaf "
          f"rel err {worst:.3e}, tol {MESH_TOL}); micro-step ms with the "
          f"mesh {[round(t, 2) for t in got['ms']]}, without "
          f"{[round(t, 2) for t in ref['ms']]} (CUDA events; the mesh run "
          f"first, its first micro-step carrying the process's first "
          f"launches and the communicator's set-up; the 8th applies Adam), "
          f"median of micro-steps 2-7 {steady[0]:.2f} with the mesh, "
          f"{steady[1]:.2f} without; the gradient "
          f"all-reduce {grad_bytes} B in {len(reduced)} calls per micro-step "
          f"({got['param_bytes']} B of parameters), {reduce_ms:.3f} ms on "
          f"parameter-shaped tensors; launches {counts}")
    return counts


def _par_excess(got: dict, ref: dict, floors: tuple) -> dict:
    """How far a world-2 rank's result (``mgar_steps`` or ``det_step``)
    stands from one process's on the same batch, each check's worst error
    over what it allows (past 1 the check fails): MGAR's loss and each
    term of the detector's to PAR_TOL (of at least 1e-3);
    gradients (Adam's first moments, ``_mu``) to PAR_TOL of each leaf's largest or
    its floor, leaves under NOISE_TOL of the median leaf held to NOISE_TOL
    of it; parameters and BatchNorm statistics to PAR_TOL of each leaf's
    largest or their floor."""
    from multimodal_gar_tpu_torch.utils.parallel_testing import (
        leaf_errors, worst_excess)
    mu_floor, par_floor = floors
    if "optimizer" in got:          # MGAR: the loss of each micro-step
        pairs = [({"loss": a["loss"]}, {"loss": b["loss"]})
                 for a, b in zip(got["metrics"], ref["metrics"])]
    else:                           # a detector: every term of its step
        pairs = [(got["metrics"], ref["metrics"])]
    loss = max(abs(a[k] - b[k]) / (PAR_TOL * max(abs(b[k]), 1e-3))
               for a, b in pairs for k in b)
    return {"loss": (loss, "metrics"),
            "gradients": worst_excess(leaf_errors(_mu(got), _mu(ref),
                                                  mu_floor),
                                      PAR_TOL, noise=True,
                                      noise_tol=NOISE_TOL),
            "parameters": worst_excess(leaf_errors(got["model"],
                                                   ref["model"], par_floor),
                                       PAR_TOL)}


def _par_floors(ref: dict, other: dict, steps: int) -> tuple:
    """The leaves' floors: SPREAD_FACTOR times one process's own spread
    between the batch's two sample orders, the parameters also 2 lr per
    step (Adam's first updates of a noise-level gradient may differ in
    sign)."""
    from multimodal_gar_tpu_torch.utils.parallel_testing import spread_floor
    return (spread_floor(_mu(ref), _mu(other), SPREAD_FACTOR),
            spread_floor(ref["model"], other["model"], SPREAD_FACTOR,
                         2 * PAR_LR * steps))


def _par_world2(cfg16, det_kw: dict, device: str = "cuda",
                threads: int = 4) -> dict:
    """14b and 14c: two processes on the one card over gloo (its all-reduce
    takes CUDA tensors; NCCL refuses two ranks on one GPU), a global batch
    of 2 at full width split b1 per rank, its samples holding 100 and 61
    people (a loss that divided by its rank's count would differ): three
    micro-steps with accumulation 1 at lr PAR_LR, every stem / window_conv
    / K3 / K4 launch of the last recorded per rank and replayed against
    its plain version; and a SECOND step at KITTI's widths through
    shard_det_batch. cuDNN runs its deterministic algorithms on both
    sides, so that one batch gives the same bits run after run. Each rank
    is held to one process's steps on the same batch (``_par_excess``),
    and the same ranks with each fault of PAR_FAULTS planted must fail
    that comparison. Dropout is off, so that the model is invariant to
    the sample order. Returns the ranks' launch counts summed."""
    from multimodal_gar_tpu_torch.utils.parallel_testing import (
        check_leaves, det_step, different_tensors, leaf_errors, mgar_steps,
        spawn)
    cfg = dataclasses.replace(cfg16, train=dataclasses.replace(
        cfg16.train, grad_accum_steps=1))
    # frames of 80-pixel squares: on white-noise frames the frozen I3D's
    # Mixed_4f map is nearly constant, so the RGB non-local block's
    # training BatchNorm takes E[x^2] - E[x]^2 of near-equal rows and turns
    # float32 rounding (any summation order, any implementation) into
    # gradient errors past 1e-4; the CPU tests condition their batch alike
    # (utils/testing.py: condition_for_grad_parity_)
    kw = dict(cfg=cfg, synthetic=dict(batch_size=2, seed=0, n_valid=100),
              people=(100, 61), frame_blocks=80, lr=PAR_LR, steps=3,
              dropout=False, deterministic=True, first_moments=True)
    det_kw = dict(det_kw, deterministic=True)
    cases = [("step", "mgar_steps", dict(kw, check_kernels=True)),
             ("det", "det_step", det_kw)]
    for label, name, case_kw in list(cases):
        cases += [((label, f), name, dict(case_kw, fault=f,
                                          check_kernels=False))
                  if name == "mgar_steps" else
                  ((label, f), name, dict(case_kw, fault=f))
                  for f in PAR_FAULTS[label]]
    job = {"mesh": (2, 1), "device": device, "threads": threads,
           "cases": cases}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ranks = spawn(2, job, root, timeout=600)
        spawn_s = time.perf_counter() - t0
    counts = {k: sum(r["step"]["launches"][k] + r["det"]["launches"][k]
                     for r in ranks) for k in PAR_MICRO_STEP}
    # one process on the batch, and on it in the other sample order
    refs = {"step": (mgar_steps(None, device, **kw),
                     mgar_steps(None, device, reverse=True, **kw)),
            "det": (det_step(None, device, **det_kw),
                    det_step(None, device, reverse=True, **det_kw))}
    floors = {k: _par_floors(ref, other, kw["steps"] if k == "step" else 1)
              for k, (ref, other) in refs.items()}
    # under deterministic cuDNN one batch gives the same bits twice, so the
    # spread over the two orders is summation order alone
    again = det_step(None, device, **det_kw)
    check(not different_tensors(again["exp_avg"], refs["det"][0]["exp_avg"]),
          "14c: one process's SECOND step differs from itself on the same "
          "batch under deterministic cuDNN")
    det_spread = leaf_errors(_mu(refs["det"][1]), _mu(refs["det"][0]))
    part = {p: max(e / s for k, (e, s, _) in det_spread.items()
                   if k.startswith(p) and s > 0)
            for p in ("trunk.", "dense_head.")}
    print(f"14c one process at b2, deterministic cuDNN: the same batch "
          f"twice bit for bit; over the batch in the other order its "
          f"gradients' worst leaf rel err in the trunk {part['trunk.']:.3e}, "
          f"in the dense head {part['dense_head.']:.3e}")
    for label, what in (("step", "14b"), ("det", "14c")):
        ref, other = refs[label]
        spread = check_leaves(leaf_errors(_mu(other), _mu(ref)),
                              float("inf"), f"{what} swapped", noise=True,
                              noise_tol=NOISE_TOL)[0]
        for r, res in enumerate(ranks):
            got = res[label]
            excess = _par_excess(got, ref, floors[label])
            worst = max(v for v, _ in excess.values())
            mu, mu_over, mu_noise = check_leaves(
                leaf_errors(_mu(got), _mu(ref), floors[label][0]), PAR_TOL,
                f"{what} rank {r} gradients", noise=True,
                noise_tol=NOISE_TOL)
            par, par_over, _ = check_leaves(
                leaf_errors(got["model"], ref["model"], floors[label][1]),
                PAR_TOL, f"{what} rank {r} parameters")
            check(worst <= 1.0, f"{what} rank {r}: {excess}")
            if label == "step":
                check(got["launches"] == {k: kw["steps"] * n for k, n in
                                          PAR_MICRO_STEP.items()},
                      f"14b rank {r}: launches {got['launches']}")
                for name, row in got["kernels"].items():
                    check(row["launches"] == PAR_MICRO_STEP[name]
                          and row["max_rel_err"] <= KERNEL_TOL,
                          f"14b rank {r}: {name} {row}")
            faults = {}
            for f in PAR_FAULTS[label]:
                bad = _par_excess(res[(label, f)], ref, floors[label])
                faults[f] = {k: (f"{v:.3g}", leaf) for k, (v, leaf) in
                             bad.items() if v > 1.0}
                check(faults[f], f"{what} rank {r}: the planted fault {f} "
                      f"passes the comparison: {bad}")
            if label == "step":
                kernels = {k: (v["launches"], f"{v['max_rel_err']:.2e}")
                           for k, v in got["kernels"].items()}
                head = (f"14b rank {r}: b1 of the global b2 at full width "
                        f"(100 / 61 people), micro-steps "
                        f"{[round(t, 2) for t in got['ms']]} ms by CUDA "
                        f"events, then the checked one; losses "
                        f"{[m['loss'] for m in got['metrics']]}; launches "
                        f"of the checked micro-step and their worst rel err "
                        f"against the plain versions {kernels}")
            else:
                head = (f"14c rank {r}: SECOND b1 of a b2 step through "
                        f"shard_det_batch, {got['ms']:.2f} ms (a first "
                        f"step: cuDNN's algorithm timing included), loss "
                        f"{got['metrics']['loss']:.6f} (one process at b2: "
                        f"{ref['metrics']['loss']:.6f}, {ref['ms']:.2f} ms)")
            print(f"{head}; gradients worst leaf rel err {mu:.3e} "
                  f"({mu_noise} leaves under {NOISE_TOL} of the median "
                  f"leaf held as noise), past {PAR_TOL} within "
                  f"{SPREAD_FACTOR} x one process's spread over the "
                  f"swapped batch ({spread:.3e} at worst): "
                  f"{_floored(mu_over)}; "
                  f"parameters {par:.3e} ({len(par_over)} leaves within "
                  f"lr * sign or the spread); worst share of the allowance "
                  f"{worst:.3f}; planted faults, each past its allowance "
                  f"(times, leaf): {faults}")
    ref = refs["step"][0]
    print(f"14b one process at b2 (the first full-width batch of 2 on the "
          f"card): micro-steps {[round(t, 2) for t in ref['ms']]} ms by CUDA "
          f"events, losses {[m['loss'] for m in ref['metrics']]}; the two "
          f"ranks' processes took {spawn_s:.1f} s from start to end, both "
          f"on the one card")
    return counts


def _mu(result: dict) -> dict:
    """Adam's first moments of a ``det_step`` result or, after its first
    micro-step, of a ``mgar_steps`` one, by parameter name: 0.1 of the
    gradient of a step from equal parameters (the later micro-steps start
    from parameters that Adam's first update, lr * sign(g), may have set
    apart where a gradient is at noise level)."""
    mu = result["first_exp_avg"] if "first_exp_avg" in result \
        else result["exp_avg"]
    return dict(zip(result["names"], mu))


def _input_width_launches(fields16, gen, device: str = "cuda",
                          widths=INPUT_WIDTHS, label: str = "14d",
                          key: str = "widths_9_15") -> tuple:
    """14d: K3, window_conv and K4 at input widths 9-15 (``widths``) over
    the 16k training rulebook's first layer (16,000 rows): each against
    its plain version and twice for equal bits, timed replayed from a CUDA
    graph through the wrapper (padding included) beside its bound at the
    unpadded width and beside the bare instance the route reaches ((12,
    16) for K3 and window_conv at 9-11, (16, 16) at 13-15 and for K4; (4,
    16) at 1-3, phase 3's case). Returns ({kernel: (max abs err, max rel
    err)}, {kernel: extra keys of the kernels line, named from ``key``})."""
    import torch
    import torch.nn.functional as F
    import multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad as k4m
    import multimodal_gar_tpu_torch.ops.kernels.subm_conv as k3m
    import multimodal_gar_tpu_torch.ops.kernels.window_conv as wcm
    from multimodal_gar_tpu_torch.ops.kernels._pad import (kernel_width,
                                                           wgrad_width)
    from multimodal_gar_tpu_torch.ops.sparse_maps import backbone_maps
    from multimodal_gar_tpu_torch.utils.testing import window_taps
    rb = {k: torch.from_numpy(v).to(device) for k, v in
          fields16["rulebook"].items()}
    idx = backbone_maps(rb, key_sorted=True, with_bwd=False)["nbr_0"].fwd
    win = rb["win_0"]
    rows, d = idx.shape[1], 16
    taps = {"subm_conv": int((idx >= 0).sum()), "sparse_wgrad":
            int((idx >= 0).sum()), "window_conv": window_taps(win)}
    worst, sums = {}, {}
    for c in widths:
        table = torch.randn((1, rows, c), device=device, generator=gen)
        w = torch.randn((27, c, d), device=device, generator=gen) \
            / (27 * c) ** .5
        dout = torch.randn((1, rows, d), device=device, generator=gen)
        runs = {
            "subm_conv": (lambda: k3m.subm_conv(table, idx, w),
                          lambda: k3m.subm_conv_plain(table, idx, w),
                          k3m._launch, (idx, w), kernel_width(c),
                          nbytes(table, idx, w) + rows * d * 4),
            "window_conv": (lambda: wcm.window_conv(table, win, w),
                            lambda: wcm.window_conv_plain(table, win, w),
                            wcm._launch, (win, w), kernel_width(c),
                            nbytes(table, win, w) + rows * d * 4),
            "sparse_wgrad": (lambda: k4m.sparse_wgrad(table, idx, dout),
                             lambda: k4m.sparse_wgrad_plain(table, idx,
                                                            dout),
                             k4m._launch, (idx, dout), wgrad_width(c),
                             nbytes(table, idx, dout) + 27 * c * d * 4)}
        for name, (kernel, plain, bare, rest, width, moved) in runs.items():
            with torch.no_grad():
                got, ref = kernel(), plain()
                err, rel = rel_err(got, ref)
                check(rel <= KERNEL_TOL,
                      f"{label} {name} at {c}: rel err {rel}")
                check(torch.equal(got, kernel()),
                      f"{label} {name} at {c}: two runs differ")
            tp = F.pad(table, (0, width - c))
            if name == "sparse_wgrad":
                args = (tp,) + rest
            else:
                args = (tp, rest[0], F.pad(rest[1], (0, 0, 0, width - c)))
            bnd = bound(2.0 * c * d * taps[name], moved)
            ms, bare_ms = graph_ms(kernel), graph_ms(lambda: bare(*args))
            plain_ms = median_ms(plain)
            a, r = worst.get(name, (0.0, 0.0))
            worst[name] = (max(a, err), max(r, rel))
            s = sums.setdefault(name, {f"{key}_graph_ms": 0.0,
                                       f"{key}_bound_ms": 0.0,
                                       f"{key}_plain_ms": 0.0})
            s[f"{key}_graph_ms"] += ms
            s[f"{key}_bound_ms"] += bnd["bound_ms"]
            s[f"{key}_plain_ms"] += plain_ms
            print(f"{label} {name} at {c} features ({width}-wide instance, "
                  f"{rows} rows, {taps[name]} taps present): {ms:.4f} ms "
                  f"replayed through the wrapper, the bare ({width}, {d}) "
                  f"kernel {bare_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']}, {bnd['bound_ms'] / ms:.1%}); plain "
                  f"{plain_ms:.4f} ms; rel err {rel:.3e}, twice equal bits")
    return worst, sums


def _waymo9_request(root: str, device: str = "cuda") -> tuple:
    """14d: a Waymo test tree with sequence_offset (-3, 0) and one-hot
    timestamps (9 point features) through the registry and det_batches
    onto the card into a request of a CenterPoint built for 9 features at
    nuScenes' geometry: outputs finite, K3 11 launches (the input layer on
    the (12, 16) instance), each replayed against its plain version.
    Returns (the launch counts, the worst errors)."""
    import torch
    from multimodal_gar_tpu_torch.data.registry import (build_dataset,
                                                        det_batches)
    from multimodal_gar_tpu_torch.detection import build_detector
    from multimodal_gar_tpu_torch.utils.testing import (
        nuscenes_centerpoint_config, write_dataset_tree)
    cfg = nuscenes_centerpoint_config()
    ds = build_dataset("WaymoDataset", **dict(
        write_dataset_tree("WaymoDataset", root), sequence_offset=(-3, 0),
        onehot_timestamp=True, point_cloud_range=cfg.point_cloud_range))
    check(ds.num_point_features == 9, f"14d: {ds.num_point_features} "
          f"Waymo features, expected 9")
    batches = list(det_batches(ds, 1, cfg.voxel_size,
                               cfg.max_voxels_per_stage[0], shuffle=False,
                               device=device))
    batch = batches[-1]                   # the frame with three past frames
    check(batch.voxels.shape[-1] == 9, f"14d: voxels {batch.voxels.shape}")
    model = build_detector("CenterPoint", cfg, in_channels=9, device=device,
                           generator=torch.Generator().manual_seed(0)).eval()
    _reset_counts()
    with torch.no_grad():
        out = model.predict(model(batch))
    if device == "cuda":
        torch.cuda.synchronize()
    counts = _counts()
    check(counts["subm_conv"] == 11 and counts["window_conv"] == 0,
          f"14d Waymo request launches {counts}")
    check(all(bool(torch.isfinite(v.float()).all()) for v in out.values()),
          "14d: non-finite Waymo predictions")
    errs = _det_kernel_checks([(model, batch, False)], NUSC_NBR,
                              "14d Waymo CenterPoint")
    print(f"14d Waymo (-3, 0) one-hot tree: {len(ds)} frames of "
          f"{ds.num_point_features} features through det_batches, the last "
          f"({int(batch.voxel_valid.sum())} voxels) into a 9-feature "
          f"CenterPoint request: launches {counts}, "
          f"{int(out['valid'].sum())} boxes kept")
    return counts, errs


def phase_parallel(cfg16, fields16) -> tuple:
    """Phase 14: the parallel layer (14a world 1 over NCCL, 14b world 2
    on the one card, 14c SECOND at world 2) and the input layer at 9-15
    features (14d). The main paths (14a's mesh run, 14b's and 14c's ranks,
    14d's Waymo request) read the launch counts from 0; returns their sum,
    the worst (abs, rel) kernel errors and the 9-15 keys of the kernels
    line."""
    import torch
    torch.cuda.empty_cache()
    det_model = _det_model("SECOND")
    det_kw = dict(name="SECOND", det_cfg=det_model.cfg, in_channels=4,
                  batch=_det_batch("SECOND", [0, 1]).to("cpu"),
                  state_dict={k: v.cpu() for k, v in
                              det_model.state_dict().items()}, lr=PAR_LR)
    del det_model
    paths = [timed("14a world 1 over NCCL", _par_world1, cfg16, fields16)]
    paths.append(timed("14b / 14c world 2 on the one card", _par_world2,
                       cfg16, det_kw))
    gen = torch.Generator(device="cuda").manual_seed(14)
    width_errs, width_keys = timed("14d input widths 9-15",
                                   _input_width_launches, fields16, gen)
    with tempfile.TemporaryDirectory() as root:
        counts, waymo_errs = timed("14d Waymo at 9 features",
                                   _waymo9_request, root)
    paths.append(counts)
    keys = set(paths[-1])
    total = {k: sum(p.get(k, 0) for p in paths) for k in keys}
    return total, _worst(width_errs, waymo_errs), width_keys


# ---------------------------------------------------------------------------
# Phase 15: serving at model.dtype bfloat16
# ---------------------------------------------------------------------------

def _ulp_line(chk: dict) -> str:
    return (f"within one bf16 ulp: {chk['ok']}, share differing "
            f"{chk['share_differing']:.3e}, most ulps apart "
            f"{chk['max_ulps']}, max abs err {chk['max_abs_err']:.3e}")


def phase_bf16_stem(gen) -> dict:
    """15a: the bf16 stem kernel against its plain version at the
    full-width shape, each element within one bf16 ulp (of the output, plus
    one of the sum before the bias that the second rounding carries), and
    its ms beside F.conv3d in bf16 and the float32 kernel's; then at B = 2
    with an H and W that no tile divides and an odd Wp (an xd the wrapper
    copies into rows of an even width). Each twice, for equal bits."""
    import torch
    import torch.nn.functional as F
    from multimodal_gar_tpu_torch.models.i3d import s2d_prep
    from multimodal_gar_tpu_torch.ops.kernels.stem_conv import (
        stem_conv, stem_conv_bf16, stem_conv_plain, stem_conv_sum)
    from multimodal_gar_tpu_torch.utils.testing import bf16_ulp_check
    dev, bf = "cuda", torch.bfloat16
    x3 = torch.randn((1, 15, 720, 1280, 3), device=dev, generator=gen)
    w7 = torch.randn((7, 7, 7, 3, 64), device=dev, generator=gen) * 0.05
    # the model's order: clip and folded kernel rounded, then s2d (exact)
    # into rows of an even width, as models/i3d.py: StemUnit3D lays them out
    xd, w2 = s2d_prep(x3.to(bf), w7.to(bf), even_width=True)
    del x3
    w2 = w2.contiguous()
    bias = (torch.randn(64, device=dev, generator=gen) * 0.1).to(bf)
    got = stem_conv_bf16(xd, w2, bias)
    again = stem_conv_bf16(xd, w2, bias)
    ref = stem_conv_plain(xd, w2, None, bias)
    pre = stem_conv_sum(xd.float(), w2.float()).to(bf)
    torch.cuda.synchronize()
    check(got.shape == ref.shape == (1, 64, 8, 360, 640)
          and got.dtype == bf, f"stem_conv_bf16 output {tuple(got.shape)}")
    check(torch.equal(got, again), "stem_conv_bf16: two runs differ")
    chk = bf16_ulp_check(got, ref, pre)
    del pre, again
    # B = 2, H_out 44 and W_out 98 (no multiple of the 6 x 64 tile), Wp odd
    x_odd = torch.randn((2, 9, 47, 101, 12), device=dev, generator=gen).to(bf)
    w7_odd = torch.randn((7, 7, 7, 3, 64), device=dev, generator=gen) * 0.05
    w_odd = s2d_prep(torch.zeros((1, 1, 8, 8, 3), device=dev),
                     w7_odd.to(bf))[1].contiguous()
    odd = stem_conv_bf16(x_odd, w_odd, bias)
    odd_again = stem_conv_bf16(x_odd, w_odd, bias)
    odd_chk = bf16_ulp_check(odd, stem_conv_plain(x_odd, w_odd, None, bias),
                             stem_conv_sum(x_odd.float(),
                                           w_odd.float()).to(bf))
    torch.cuda.synchronize()
    print(f"15a stem_conv_bf16 {tuple(x_odd.shape)} -> {tuple(odd.shape)}: "
          f"{_ulp_line(odd_chk)}, twice equal "
          f"{torch.equal(odd, odd_again)}")
    check(odd.shape == (2, 64, 5, 44, 98) and odd_chk["ok"]
          and torch.equal(odd, odd_again),
          f"stem_conv_bf16 at B = 2, odd Wp: {odd_chk}")
    ms, call_ms = kernel_ms(lambda: stem_conv_bf16(xd, w2, bias,
                                                   w2_is_s2d=True))
    plain_ms = median_ms(lambda: stem_conv_plain(xd, w2, None, bias))
    del ref
    x_s2d, w_s2d = xd.permute(0, 4, 1, 2, 3), w2.permute(4, 3, 0, 1, 2)
    lib_ms = median_ms(lambda: F.conv3d(x_s2d, w_s2d, stride=(2, 1, 1),
                                        padding=(3, 0, 0)))
    x32, w32 = xd.float().contiguous(), w2.float()
    one, b32 = torch.ones(64, device=dev), bias.float()
    f32_ms, _ = kernel_ms(lambda: stem_conv(x32, w32, one, b32,
                                            w2_is_s2d=True))
    bnd = bound(2.0 * got[0, 0].numel() * 64 * 7 * 7 * 7 * 3,
                nbytes(xd, w2, bias, got), PEAK_BF16_FLOPS)
    print(f"15a stem_conv_bf16 {tuple(xd.shape)} -> {tuple(got.shape)}: "
          f"{_ulp_line(chk)}; kernel {ms:.4f} ms (per call {call_ms:.4f}),"
          f" plain {plain_ms:.3f} ms, F.conv3d bf16 alone {lib_ms:.4f} ms, "
          f"float32 kernel {f32_ms:.4f} ms; bf16 bound {bnd['bound_ms']:.4f}"
          f" ms by {bnd['bound_by']} ({bnd['flop']:.3e} FLOP, "
          f"{bnd['bytes']:.3e} B) = {bnd['bound_ms'] / ms:.1%} reached")
    check(chk["ok"], f"stem_conv_bf16 not within one bf16 ulp: {chk}")
    return {"max_abs_err": chk["max_abs_err"], "max_ulps": chk["max_ulps"],
            "share_differing": chk["share_differing"], "ms": ms,
            "per_call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "library_ms": lib_ms, "f32_kernel_ms": f32_ms,
            "odd_max_ulps": odd_chk["max_ulps"]}


def phase_bf16_sparse(rulebooks: dict, caps, gen) -> tuple:
    """15b: the bf16 window_conv and K3 forward over the 11 layers of each
    rulebook of ``rulebooks`` (x-window maps for the first, nbr / down maps
    for the second), each within one bf16 ulp of its plain version; ms per
    layer replayed from a CUDA graph beside the float32 kernel's and the
    bf16 bound. Returns (window entry, K3 entry): the first rulebook's
    numbers, the others' added as ``<name>_*``."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.subm_conv import (
        subm_conv, subm_conv_bf16, subm_conv_plain)
    from multimodal_gar_tpu_torch.ops.kernels.window_conv import (
        window_conv, window_conv_bf16, window_conv_plain)
    from multimodal_gar_tpu_torch.utils.testing import (BACKBONE_LAYERS,
                                                        bf16_ulp_check,
                                                        window_taps)
    dev, bf = "cuda", torch.bfloat16
    kinds = {"window_conv_bf16": (window_conv_bf16, window_conv,
                                  window_conv_plain),
             "subm_conv_bf16": (subm_conv_bf16, subm_conv, subm_conv_plain)}
    entries = {k: {} for k in kinds}
    for book, rulebook in rulebooks.items():
        for kind, (fn, fn32, plain) in kinds.items():
            total = Totals(peak_flops=PEAK_BF16_FLOPS)
            f32_ms = 0.0
            most_ulps, share = 0, 0.0
            for name, key, _, table_stage, c, d in BACKBONE_LAYERS:
                maps = torch.from_numpy(
                    rulebook[key if kind == "window_conv_bf16"
                             else _map_key(name)]).to(dev)
                m = caps[table_stage]
                feats = torch.randn((1, m, c), device=dev,
                                    generator=gen).to(bf)
                w = (torch.randn((27, c, d), device=dev, generator=gen)
                     / (27 * c) ** .5).to(bf)
                got = fn(feats, maps, w)
                again = fn(feats, maps, w)
                ref = plain(feats, maps, w)
                torch.cuda.synchronize()
                chk = bf16_ulp_check(got, ref)
                check(chk["ok"], f"15b {kind} [{book}] {name}: {chk}")
                check(torch.equal(got, again),
                      f"15b {kind} [{book}] {name}: two runs differ")
                ms = graph_ms(lambda: fn(feats, maps, w))
                f32, w32 = feats.float(), w.float()
                ms32 = graph_ms(lambda: fn32(f32, maps, w32))
                plain_ms = median_ms(lambda: plain(feats, maps, w))
                present = (window_taps(maps) if kind == "window_conv_bf16"
                           else int((maps >= 0).sum()))
                bnd = bound(2.0 * c * d * present,
                            nbytes(feats, maps, w, got), PEAK_BF16_FLOPS)
                print(f"15b {kind} [{book}] {name}: R {maps.shape[1]} M {m}"
                      f" C {c} D {d}, {present} taps: {_ulp_line(chk)}; "
                      f"graph replay {ms:.4f} ms (float32 kernel "
                      f"{ms32:.4f}), plain {plain_ms:.3f} ms; bf16 bound "
                      f"{bnd['bound_ms']:.5f} ms by {bnd['bound_by']}")
                total.add(chk["max_abs_err"], 0.0, ms, ms, plain_ms, bnd)
                f32_ms += ms32
                most_ulps = max(most_ulps, chk["max_ulps"])
                share = max(share, chk["share_differing"])
            entry = total.entry()
            entry.pop("max_rel_err")
            entry.update(max_ulps=most_ulps, share_differing=share,
                         f32_kernel_ms=f32_ms)
            print(f"15b {kind} [{book}], 11 layers: graph replay "
                  f"{total.ms:.4f} ms against the float32 kernel's "
                  f"{f32_ms:.4f} ms, bf16 bound {total.bound_ms:.4f} ms = "
                  f"{total.bound_ms / total.ms:.1%} reached; no single "
                  f"PyTorch call computes it")
            if not entries[kind]:
                entries[kind] = entry
            else:
                entries[kind].update({f"{book}_{k}": v for k, v in
                                      entry.items() if k in (
                                          "ms", "plain_ms", "bound_ms",
                                          "f32_kernel_ms", "max_ulps")})
    _bf16_sparse_edges(kinds)
    return entries["window_conv_bf16"], entries["subm_conv_bf16"]


def _bf16_sparse_edges(kinds: dict) -> None:
    """15b at the sparse core's edges (utils/testing.py: window_edge_cases:
    fewer rows than one tile and than 132 tiles, a 128-row stretch with no
    tap present, a launch with none, B = 2 with R != M, the input layer
    padded to 16 over 34,000 rows with a stretch of absent ones):
    window_conv over the packed maps and K3 over the same maps decoded,
    each within one bf16 ulp of its plain version and twice for equal
    bits."""
    import torch
    from multimodal_gar_tpu_torch.utils.testing import (bf16_ulp_check,
                                                        window_edge_cases,
                                                        window_index_map)
    bf = torch.bfloat16
    for name, f, win, w in window_edge_cases(seed=1):
        feats = torch.from_numpy(f).cuda().to(bf)
        wt = torch.from_numpy(w).cuda().to(bf)
        win = torch.from_numpy(win).cuda()
        maps = {"window_conv_bf16": win,
                "subm_conv_bf16": window_index_map(win, feats.shape[1])}
        for kind, (fn, _, plain) in kinds.items():
            got = fn(feats, maps[kind], wt)
            again = fn(feats, maps[kind], wt)
            chk = bf16_ulp_check(got, plain(feats, maps[kind], wt))
            torch.cuda.synchronize()
            print(f"15b {kind} edge [{name}] B {win.shape[0]} R "
                  f"{win.shape[1]} M {feats.shape[1]} C {f.shape[-1]} D "
                  f"{w.shape[-1]}: {_ulp_line(chk)}, twice equal "
                  f"{torch.equal(got, again)}")
            check(chk["ok"] and torch.equal(got, again),
                  f"15b {kind} edge [{name}]: {chk}")


def _bf16_tiny_card_vs_cpu() -> dict:
    """15c: a tiny bf16 MGAR on the card (the bf16 kernels) against the
    same on the CPU (their plain versions), every output within
    BF16_MODEL_TOL of its largest CPU value."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, synthetic_batch_numpy, tiny_config)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="bfloat16"))
    fields = synthetic_batch_numpy(cfg, batch_size=2, seed=0)
    ref = make_eval_step(_model(cfg, "cpu"))(batch_from_numpy(fields))
    _reset_counts()
    got = make_eval_step(_model(cfg, DEVICE))(
        batch_from_numpy(fields, DEVICE)).to("cpu")
    counts = _counts()
    check(counts["stem_conv_bf16"] == 1 and counts["window_conv_bf16"] == 11
          and counts["stem_conv"] == counts["window_conv"] == 0,
          f"15c tiny bf16 forward launches {counts}")
    refs = dict(_outputs(ref))
    worst = 0.0
    for name, t in _outputs(got):
        _, rel = rel_err(t, refs[name])
        check(rel <= BF16_MODEL_TOL, f"15c tiny bf16 {name}: rel err {rel}")
        worst = max(worst, rel)
    print(f"15c tiny bf16 MGAR, card vs CPU: max rel err {worst:.3e} over "
          f"{len(refs)} outputs (bound {BF16_MODEL_TOL})")
    return counts


# MGAR's modules whose device time a request is split into (15d)
_MGAR_SPLIT = (("I3D", "rgb_backbone.i3d"), ("RGB branch", "rgb_backbone"),
               ("sparse backbone", "lidar_backbone.backbone3d"),
               ("grid pool", "lidar_backbone.roi_grid_pool"),
               ("LiDAR branch", "lidar_backbone"),
               ("fusion and heads", "gar_fusion"))


# a voxel detector's (15e)
_DET_SPLIT = (("trunk", "trunk"), ("sparse backbone", "trunk.backbone_3d"),
              ("conv_out", "trunk.conv_out"),
              ("BEV backbone", "trunk.backbone_2d"), ("head", "dense_head"))
# the families whose modules lie elsewhere
_DET_SPLITS = {
    "PartA2": (("UNetV2", "backbone_3d"), ("its encoder",
                                            "backbone_3d.encoder"),
               ("conv_out", "conv_out"), ("BEV backbone", "backbone_2d"),
               ("RPN head", "dense_head"), ("refinement", "rcnn_head")),
    "VoxelNeXt": (("sparse backbone", "backbone_3d"),
                  ("conv_out", "backbone_3d.conv_out"),
                  ("shared_conv", "backbone_3d.shared_conv"),
                  ("heads", "hm_out"))}


def _module_ms(model, fn, split=_MGAR_SPLIT) -> dict:
    """ms by CUDA events of each module of ``split`` ((name, submodule
    path) pairs) over one ``fn()`` (events recorded by forward hooks; a
    module includes its parts)."""
    import torch
    marks, handles = {}, []
    for name, path in split:
        mod = model.get_submodule(path)

        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name] = [ev]

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name].append(ev)
        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {name: round(a.elapsed_time(b), 3)
            for name, (a, b) in marks.items()}


def _bf16_requests(fields, x_window: bool) -> dict:
    """15d: 3 full-width bf16 requests on one sparse path by CUDA events
    beside the float32 request (same weights), peak memory of each, and the
    bf16 outputs against the float32 ones on the card."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import make_eval_step
    from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                        flagship_config)
    path = "x-window" if x_window else "nbr-map"
    kernel = "window_conv" if x_window else "subm_conv"
    cfgs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = flagship_config(dtype=dtype)
        cfgs[dtype] = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, lidar=dataclasses.replace(cfg.model.lidar,
                                                 x_window=x_window)))
    batch = batch_from_numpy(fields, DEVICE)
    valid = batch.person_valid
    total = {}
    outs, times, peaks = {}, {}, {}
    for dtype, cfg in cfgs.items():
        model = _model(cfg, DEVICE)
        eval_step = make_eval_step(model)
        eval_step(batch)                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[dtype] = []
        for i in range(3 if dtype == "bfloat16" else 1):
            _reset_counts()
            out, ms = _event_ms(lambda: eval_step(batch))
            ran = _counts()
            times[dtype].append(ms)
            suffix = "_bf16" if dtype == "bfloat16" else ""
            want = {f"stem_conv{suffix}": 1, f"{kernel}{suffix}": 11}
            check(all(ran[k] == n for k, n in want.items())
                  and sum(ran.values()) == 12,
                  f"15d {path} {dtype} request {i}: launches {ran}")
            check_outputs(out, valid)
            if dtype == "bfloat16":
                for k, n in ran.items():
                    total[k] = total.get(k, 0) + n
        peaks[dtype] = torch.cuda.max_memory_allocated() / 2 ** 30
        outs[dtype] = out
        split = _module_ms(model, lambda: eval_step(batch))
        print(f"15d {path} {dtype}: one more request split by module, ms "
              f"by CUDA events: {split}")
        del eval_step, model
    ref, got = outs["float32"], outs["bfloat16"]
    refs = dict(_outputs(ref))
    gaps = {name: rel_err(t, refs[name])[1] for name, t in _outputs(got)}
    for name in ("rgb_features", "lidar_features"):
        check(gaps[name] <= BF16_FEATURE_TOL, f"15d {path}: bf16 {name} "
              f"{gaps[name]:.3e} from float32 > {BF16_FEATURE_TOL}")
    check(gaps["a_theta"] <= BF16_A_THETA_TOL, f"15d {path}: bf16 a_theta "
          f"{gaps['a_theta']:.3e} from float32 > {BF16_A_THETA_TOL}")
    print(f"15d {path}, full width (1 x 15 x 720 x 1280, 100 actors, 40k "
          f"voxels): bf16 request ms by CUDA events "
          f"{[round(t, 3) for t in times['bfloat16']]} against float32 "
          f"{[round(t, 3) for t in times['float32']]}; peak "
          f"{peaks['bfloat16']:.2f} GiB against {peaks['float32']:.2f} GiB; "
          f"bf16 against float32 (of the largest float32 value): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + "; outputs finite, padded rows zero, a_theta's diagonal 1")
    return total


# the five (C, D) pairs the bf16 kernels had before the wide ones (the
# transposed pairs for kernel C): their times are 15b's and 16a's
BF16_FIRST_PAIRS = {"subm_conv_bf16": {(16, 16), (16, 32), (32, 32),
                                       (32, 64), (64, 64)},
                    "window_conv_bf16": {(16, 16), (16, 32), (32, 32),
                                         (32, 64), (64, 64)},
                    "subm_conv_dgrad_bf16": {(16, 16), (32, 16), (32, 32),
                                             (64, 32), (64, 64)},
                    "sparse_wgrad_bf16": {(16, 16), (16, 32), (32, 32),
                                          (32, 64), (64, 64)}}
# the bf16 sparse launches of one request at KITTI's widths (15e) and of
# one b2 train step (16e): SECOND over the nbr maps, CenterPoint and
# PartA2 on the x-window path (PartA2's UNetV2 decoder, 16 layers, on the
# forward core over the nbr and inverse maps), VoxelNeXt's 30 residual
# layers and shared_conv; kernel C skips each backbone's conv_input
BF16_DET_REQUEST = {
    "SECOND": {"subm_conv_bf16": 11},
    "CenterPoint": {"window_conv_bf16": 11},
    "PartA2": {"window_conv_bf16": 11, "subm_conv_bf16": 16},
    "VoxelNeXt": {"subm_conv_bf16": 31}}
BF16_DET_STEP = {
    "SECOND": {"subm_conv_bf16": 11, "subm_conv_dgrad_bf16": 10,
               "sparse_wgrad_bf16": 11},
    "CenterPoint": {"window_conv_bf16": 11, "subm_conv_dgrad_bf16": 10,
                    "sparse_wgrad_bf16": 11},
    "PartA2": {"window_conv_bf16": 11, "subm_conv_bf16": 16,
               "subm_conv_dgrad_bf16": 26, "sparse_wgrad_bf16": 27},
    "VoxelNeXt": {"subm_conv_bf16": 31, "subm_conv_dgrad_bf16": 30,
                  "sparse_wgrad_bf16": 31}}
# the recorded sites' names (_sparse_sites, kernel C's own) -> the bf16
# kernels' counters
_BF16_SITE = {"subm_conv": "subm_conv_bf16", "window_conv":
              "window_conv_bf16", "sparse_wgrad": "sparse_wgrad_bf16",
              "subm_conv_dgrad_bf16": "subm_conv_dgrad_bf16"}
# {(kernel, (C, D)): [launches, graph-replayed ms, bound ms, most ulps or
# share differing]} of the wide pairs over 15e, 16e and 12g: the PERF.md
# rows of the pairs past VoxelBackbone8x's; and each bf16 kernel's largest
# abs err over those replays
WIDE_PAIRS = {}
BF16_REPLAY_ERR = {}


def _bf16_replay(calls, kernels, what: str) -> dict:
    """Every recorded bf16 sparse launch of ``calls`` replayed through its
    kernel and its plain version: the forward core and kernel D within one
    bf16 ulp, kernel C within one ulp of its largest tap product (at a
    wide pair one ulp of each tap product that enters the element:
    dgrad_tap_ulps), kernel D twice with equal bits (largest abs errs into
    BF16_REPLAY_ERR); each
    launch of a pair beyond the first five (BF16_FIRST_PAIRS) timed
    replayed from a CUDA graph (runs of 20) beside its bf16 bound, the
    bytes it must move at 3.35 TB/s or its present taps' products at 989
    TFLOP/s, into WIDE_PAIRS."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels._pad import kernel_width
    from multimodal_gar_tpu_torch.utils.testing import (bf16_ulp_check,
                                                        dgrad_bf16_check,
                                                        dgrad_tap_max,
                                                        dgrad_tap_ulps,
                                                        window_taps)
    worst, seen = {}, {}
    with torch.no_grad():
        for i, (site, args) in enumerate(calls):
            name = _BF16_SITE[site]
            kernel, plain = kernels[site]
            got, ref = kernel(*args), plain(*args)
            a, maps, b = args
            if name == "subm_conv_dgrad_bf16":
                pair = tuple(b.shape[1:])                    # (D, C)
                # a wide pair's element may see two taps land one ulp
                # apart each (utils/testing.py: dgrad_bf16_check)
                wide = pair not in BF16_FIRST_PAIRS[name]
                chk = dgrad_bf16_check(
                    got, ref, dgrad_tap_max(*args),
                    dgrad_tap_ulps(*args) if wide else None)
                moved = nbytes(*args) + got.numel() * 4
            else:
                chk = bf16_ulp_check(got, ref)
                pair = (kernel_width(a.shape[-1], a.dtype), b.shape[-1])
                moved = nbytes(*args) + got.numel() * 2
            check(chk["ok"], f"{what} {name} {pair} launch {i}: {chk}")
            if name == "sparse_wgrad_bf16":
                check(torch.equal(got, kernel(*args)),
                      f"{what} kernel D {pair} launch {i}: two runs differ")
            worst[name] = max(worst.get(name, 0.0), chk["max_abs_err"])
            BF16_REPLAY_ERR[name] = max(BF16_REPLAY_ERR.get(name, 0.0),
                                        worst[name])
            seen[name] = seen.get(name, 0) + 1
            if pair in BF16_FIRST_PAIRS[name]:
                continue
            taps = (window_taps(maps) if name == "window_conv_bf16"
                    else int(((maps >= 0) & (maps < a.shape[1])).sum()))
            bnd = bound(2.0 * pair[0] * pair[1] * taps, moved,
                        PEAK_BF16_FLOPS)
            ms = graph_ms(lambda: kernel(*args))
            row = WIDE_PAIRS.setdefault((name, pair), [0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += ms
            row[2] += bnd["bound_ms"]
            row[3] = max(row[3], chk.get("max_ulps",
                                         chk["share_differing"]))
    errs = {k: f"{v:.3e}" for k, v in worst.items()}
    print(f"{what}: each of {len(calls)} bf16 sparse launches ({seen}) "
          f"against its plain version on its own inputs (one bf16 ulp; "
          f"kernel C of its largest tap product; kernel D twice equal "
          f"bits), largest abs err {errs}")


def _bf16_detector(name: str, x_window: bool) -> tuple:
    """15e: one detector at KITTI's widths in bf16: 3 requests, each
    launching BF16_DET_REQUEST[name] and no float32 sparse kernel, every
    bf16 sparse launch of one request replayed against its plain version
    (_bf16_replay), the outputs against the float32 request's."""
    import torch
    want = BF16_DET_REQUEST[name]
    batch = _det_batch(name, [0], x_window=x_window)
    model = _det_model(name, dtype="bfloat16", x_window=x_window)
    _reset_counts()
    preds, _, req_ms, _ = _serve(
        model, batch, {**want, "subm_conv": 0, "window_conv": 0},
        f"15e {name} bf16")
    counts = _counts()

    def request():
        with torch.no_grad():
            model.eval()(batch)
    calls, kernels = _recorded_launches(request)
    check(len(calls) == sum(want.values())
          and all(a[0].dtype == torch.bfloat16 for _, a in calls),
          f"15e {name}: {len(calls)} sparse launches, not all in bf16")
    _bf16_replay(calls, kernels, f"15e {name} request")
    ref_model = _det_model(name, x_window=x_window)
    ref_preds, _, ref_ms, _ = _serve(
        ref_model, batch, {k.replace("_bf16", ""): n
                           for k, n in want.items()},
        f"15e {name} float32", n=1)
    split = _DET_SPLITS.get(name, _DET_SPLIT)
    for dtype, m in (("bfloat16", model), ("float32", ref_model)):
        with torch.no_grad():
            ms = _module_ms(m, lambda: m(batch), split)
        print(f"15e {name} {dtype}: one more forward split by module, ms "
              f"by CUDA events: {ms}")
    gaps = {n: rel_err(t, dict(_det_outputs(ref_preds))[n])[1]
            for n, t in _det_outputs(preds) if t.is_floating_point()}
    print(f"15e {name} ({'x-window' if x_window else 'nbr-map'}) bf16: "
          f"request ms {[round(t, 3) for t in req_ms]} against float32 "
          f"{[round(t, 3) for t in ref_ms]}; launches per request {want}; "
          f"outputs finite, against float32 (of its largest): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    if name == "PartA2":
        _profiler_server_capture(model, batch)
    return counts


def _profiler_server_capture(model, batch) -> None:
    """15e: utils/profiling.py's start_server on a free local port, a
    200 ms capture asked for over HTTP while the main thread serves
    requests of ``model``: the trace written names the bf16 forward
    core's and window_conv's kernels."""
    import threading
    import urllib.request
    import torch
    from multimodal_gar_tpu_torch.utils.profiling import start_server
    with tempfile.TemporaryDirectory() as logdir:
        server = start_server(0, logdir=logdir)
        reply, n = {}, 0
        try:
            port = server.server_address[1]

            def ask():
                with urllib.request.urlopen(
                        f"http://localhost:{port}/capture?ms=200",
                        timeout=60) as r:
                    reply.update(json.load(r))
            asker = threading.Thread(target=ask)
            asker.start()
            while asker.is_alive():
                with torch.no_grad():
                    model.eval()(batch)
                torch.cuda.synchronize()
                n += 1
            asker.join()
        finally:
            server.shutdown()
            server.server_close()
        check("trace" in reply, f"15e start_server: reply {reply}")
        with open(reply["trace"]) as f:
            text = f.read()
        names = {k: text.count(k) for k in ("subm_conv_wgmma_kernel",
                                            "window_conv_bf16_kernel")}
        check(all(names.values()), f"15e start_server: the 200 ms trace "
              f"names the kernels {names}")
        print(f"15e profiling.start_server: a 200 ms capture over HTTP "
              f"during {n} PartA2 bf16 requests, {len(text)} bytes of "
              f"trace naming {names}")


def _bf16_cli_eval(device=None) -> dict:
    """15f, the command line: ``python -m multimodal_gar_tpu_torch eval
    --set model.dtype=bfloat16`` through its ``main`` on a small on-disk
    synthetic JRDB (data/synthetic.py) and a float32 checkpoint of the
    seeded model, on the card by default (``device`` None): the bf16
    kernels launch and the evaluation's metrics are finite."""
    import torch
    import yaml
    from multimodal_gar_tpu_torch.__main__ import main
    from multimodal_gar_tpu_torch.config import config_to_dict
    from multimodal_gar_tpu_torch.data.synthetic import write_synthetic_jrdb
    from multimodal_gar_tpu_torch.models import MGAR
    from multimodal_gar_tpu_torch.train.checkpoint import CheckpointManager
    from multimodal_gar_tpu_torch.train.train_state import (TrainState,
                                                            make_optimizer)
    from multimodal_gar_tpu_torch.utils.testing import tiny_config
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_jrdb(os.path.join(root, "jrdb"), num_seqs=1,
                             frames_per_seq=3, people_per_frame=4,
                             image_hw=(48, 80))
        cfg = tiny_config(num_people=6, image_hw=(48, 80))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, root=os.path.join(root, "jrdb")))
        path = os.path.join(root, "tiny.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(json.loads(json.dumps(config_to_dict(cfg))), f)
        model = MGAR(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
        work = os.path.join(root, "work")
        CheckpointManager(os.path.join(work, "checkpoints")).save(
            0, TrainState(model=model, optimizer=make_optimizer(
                model.parameters(), cfg.train.stages[0], 1, 1, 0.1)))
        argv = ["eval", "--config", path, "--workdir", work, "--set",
                "model.dtype=bfloat16"]
        _reset_counts()
        t0 = time.perf_counter()
        check(main(argv + (["--device", device] if device else [])) == 0,
              "15f: the CLI's eval at bf16 failed")
        seconds = time.perf_counter() - t0
        counts = _counts()
        if device is None:
            check(counts["stem_conv_bf16"] > 0
                  and counts["window_conv_bf16"] > 0
                  and counts["stem_conv"] == counts["window_conv"] == 0,
                  f"15f: the CLI's bf16 eval launches {counts}")
        check(os.path.exists(os.path.join(work, "results", "eval",
                                          "grouping.txt")),
              "15f: the CLI's bf16 eval wrote no results")
    print(f"15f `python -m multimodal_gar_tpu_torch eval --set "
          f"model.dtype=bfloat16` on a synthetic JRDB: {seconds:.1f} s, "
          f"launches {counts}")
    return counts


def phase_bf16_serving(fields) -> dict:
    """15c-15f; returns the launch counts of the full-width paths (15d,
    15e) and of the CLI's eval (15f)."""
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
    _bf16_tiny_card_vs_cpu()
    add(_bf16_requests(fields, x_window=True))
    add(_bf16_requests(fields, x_window=False))
    for name, xw in (("SECOND", False), ("CenterPoint", True),
                     ("PartA2", True), ("VoxelNeXt", False)):
        add(timed(f"15e {name}", _bf16_detector, name, xw))
    add(_bf16_cli_eval())
    return totals


# phase 16: bf16 training. A bf16 micro-step at the 16k cap launches these
# (16c); no float32 sparse kernel and no float32 stem
BF16_MICRO_STEP = {"stem_conv_bf16": 1, "subm_conv_dgrad_bf16": 10,
                   "sparse_wgrad_bf16": 11, "stem_conv": 0,
                   "window_conv": 0, "subm_conv": 0, "sparse_wgrad": 0}
# 16b: a tiny bf16 train step, card against CPU: each loss term and
# BatchNorm statistic within this share of its (largest) CPU value (bf16
# sums in other orders through ~20 layers, each rounding at 4e-3)
BF16_TRAIN_TOL = 2e-2


def phase_bf16_grad_kernels(fields16, clustered16, caps16, gen) -> tuple:
    """16a: kernel C (the bf16 data gradient, 10 layers) and kernel D (the
    bf16 weight gradient, 11 layers) on the synthetic and the clustered
    16k training rulebooks against their plain versions: kernel C's
    float32 elements within one bf16 ulp of the largest tap product that
    enters each (utils/testing.py: dgrad_bf16_check), kernel D's bf16 dW
    within one ulp and equal bits over two runs; ms per layer replayed
    from a CUDA graph and each layer's thread-block cluster size, beside
    the float32 K3 data gradient and K4 at the same shapes, and the bf16
    bound over the present taps. Returns the two
    entries of the ``kernels`` line (the synthetic rulebook's numbers, the
    clustered one's added as ``clustered_*``)."""
    import torch
    from multimodal_gar_tpu_torch.ops.kernels.sparse_wgrad import (
        sparse_wgrad, sparse_wgrad_bf16, sparse_wgrad_bf16_cluster,
        sparse_wgrad_plain)
    from multimodal_gar_tpu_torch.ops.kernels.subm_conv import (
        subm_conv, subm_conv_dgrad_bf16, subm_conv_dgrad_bf16_cluster,
        subm_conv_dgrad_bf16_plain)
    from multimodal_gar_tpu_torch.ops.sparse_maps import backbone_maps
    from multimodal_gar_tpu_torch.utils.testing import (BACKBONE_LAYERS,
                                                        bf16_ulp_check,
                                                        dgrad_bf16_check,
                                                        dgrad_tap_max)
    dev, bf = "cuda", torch.bfloat16
    entries = {"dgrad": {}, "wgrad": {}}
    for book, fields in (("synthetic", fields16),
                         ("clustered", clustered16)):
        maps = backbone_maps({k: torch.from_numpy(v).to(dev) for k, v in
                              fields["rulebook"].items()}, key_sorted=True)
        dgrad = Totals(peak_flops=PEAK_BF16_FLOPS)
        wgrad = Totals(peak_flops=PEAK_BF16_FLOPS)
        f32 = {"dgrad": 0.0, "wgrad": 0.0}
        share = {"dgrad": 0.0, "wgrad": 0.0}
        for name, _, _, table_stage, c, d in BACKBONE_LAYERS:
            m = maps[_map_key(name)]
            rows = m.fwd.shape[1]
            dout = torch.randn((1, rows, d), device=dev, generator=gen).to(bf)
            w = (torch.randn((27, c, d), device=dev, generator=gen)
                 / (27 * c) ** .5).to(bf)
            present = int((m.fwd >= 0).sum())
            if name != "conv_input":     # no gradient to the voxel inputs
                wt = m.dgrad_weights(w)
                got = subm_conv_dgrad_bf16(dout, m.bwd, wt)
                ref = subm_conv_dgrad_bf16_plain(dout, m.bwd, wt)
                chk = dgrad_bf16_check(got, ref, dgrad_tap_max(dout, m.bwd,
                                                               wt))
                del ref
                check(chk["ok"], f"16a kernel C [{book}] {name}: {chk}")
                ms = graph_ms(lambda: subm_conv_dgrad_bf16(dout, m.bwd, wt))
                cluster = subm_conv_dgrad_bf16_cluster(1, m.bwd.shape[1], d,
                                                      c)
                d32, wt32 = dout.float(), wt.float()
                ms32 = graph_ms(lambda: subm_conv(d32, m.bwd, wt32))
                plain_ms = median_ms(
                    lambda: subm_conv_dgrad_bf16_plain(dout, m.bwd, wt))
                taps = int((m.bwd >= 0).sum())
                bnd = bound(2.0 * c * d * taps, nbytes(dout, m.bwd, wt, got),
                            PEAK_BF16_FLOPS)
                dgrad.add(chk["max_abs_err"], 0.0, ms, ms, plain_ms, bnd)
                f32["dgrad"] += ms32
                share["dgrad"] = max(share["dgrad"], chk["share_differing"])
                print(f"16a kernel C [{book}] {name}: R {m.bwd.shape[1]} M "
                      f"{rows} C {d} D {c}, {taps} taps, cluster {cluster}: "
                      f"within one bf16 ulp"
                      f" of its largest tap product, share differing "
                      f"{chk['share_differing']:.3e}, max abs err "
                      f"{chk['max_abs_err']:.3e}; graph replay {ms:.4f} ms "
                      f"(float32 K3 data gradient {ms32:.4f}), plain "
                      f"{plain_ms:.3f} ms; bf16 bound {bnd['bound_ms']:.5f} "
                      f"ms by {bnd['bound_by']}")
            table = torch.randn((1, caps16[table_stage], c), device=dev,
                                generator=gen).to(bf)
            # the map's tap columns, made once per map as in training
            taps_t = m.fwd_taps
            got = sparse_wgrad_bf16(table, m.fwd, dout, taps_t)
            chk = bf16_ulp_check(got, sparse_wgrad_plain(table, m.fwd, dout))
            check(chk["ok"], f"16a kernel D [{book}] {name}: {chk}")
            check(torch.equal(got, sparse_wgrad_bf16(table, m.fwd, dout,
                                                     taps_t)),
                  f"16a kernel D [{book}] {name}: two runs differ")
            ms = graph_ms(lambda: sparse_wgrad_bf16(table, m.fwd, dout,
                                                    taps_t))
            t32, d32 = table.float(), dout.float()
            ms32 = graph_ms(lambda: sparse_wgrad(t32, m.fwd, d32))
            plain_ms = median_ms(lambda: sparse_wgrad_plain(table, m.fwd,
                                                            dout))
            bnd = bound(2.0 * c * d * present,
                        nbytes(table, m.fwd, dout, got), PEAK_BF16_FLOPS)
            wgrad.add(chk["max_abs_err"], 0.0, ms, ms, plain_ms, bnd)
            f32["wgrad"] += ms32
            share["wgrad"] = max(share["wgrad"], chk["share_differing"])
            print(f"16a kernel D [{book}] {name}: R {rows} M "
                  f"{table.shape[1]} C {c} D {d}, {present} taps, cluster "
                  f"{sparse_wgrad_bf16_cluster()}: "
                  f"{_ulp_line(chk)}, twice equal; graph replay {ms:.4f} ms"
                  f" (float32 K4 {ms32:.4f}), plain {plain_ms:.3f} ms; bf16"
                  f" bound {bnd['bound_ms']:.5f} ms by {bnd['bound_by']}")
        for kind, tot, what in (("dgrad", dgrad, "kernel C, 10 layers"),
                                ("wgrad", wgrad, "kernel D, 11 layers")):
            entry = tot.entry()
            entry.pop("max_rel_err")
            entry.pop("per_call_ms")
            entry.update(share_differing=share[kind],
                         f32_kernel_ms=f32[kind])
            print(f"16a {what} [{book}]: graph replay {tot.ms:.4f} ms "
                  f"against the float32 kernel's {f32[kind]:.4f} ms, plain "
                  f"{tot.plain_ms:.3f} ms, bf16 bound {tot.bound_ms:.4f} ms"
                  f" = {tot.bound_ms / tot.ms:.1%} reached; no single "
                  f"PyTorch call computes it")
            if not entries[kind]:
                entries[kind] = entry
            else:
                entries[kind].update({f"{book}_{k}": v for k, v in
                                      entry.items() if k in (
                                          "ms", "plain_ms", "bound_ms",
                                          "f32_kernel_ms",
                                          "share_differing")})
        del maps
    return entries["dgrad"], entries["wgrad"]


def _loss_terms_and_grads(model, batch) -> tuple:
    """One training forward and backward of ``model``: ({term: loss},
    {parameter: gradient}, {BatchNorm statistic: its new value})."""
    import torch
    from multimodal_gar_tpu_torch.train.losses import (compute_losses,
                                                       total_loss)
    model.train()
    losses = compute_losses(model(batch), batch)
    loss = total_loss(losses, "L_total")
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return ({k: v.detach().cpu() for k, v in
             dict(losses, L_total=loss).items()},
            {k: (torch.zeros_like(p) if g is None else g).cpu()
             for (k, p), g in zip(params.items(), grads)},
            {k: v.cpu() for k, v in model.state_dict().items()
             if "running_" in k})


def _bf16_tiny_train_card_vs_cpu() -> dict:
    """16b: a tiny bf16 train step on the card (kernels C and D, the bf16
    forward kernels) against the same on the CPU (their plain versions):
    the same seeded weights and conditioned batch, dropout off. Each loss
    term within BF16_TRAIN_TOL of its CPU value, each new BatchNorm
    statistic within it of its largest, every gradient finite and each
    sparse layer's weight gradient non-zero; each leaf's distance
    printed."""
    import torch
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, condition_for_grad_parity_, prepare_grad_parity_,
        synthetic_batch_numpy, tiny_config)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="bfloat16"))
    fields = condition_for_grad_parity_(
        synthetic_batch_numpy(cfg, batch_size=2, seed=0))
    runs = {}
    for dev in ("cpu", DEVICE):
        if dev == DEVICE:
            _reset_counts()
        runs[dev] = _loss_terms_and_grads(
            prepare_grad_parity_(_model(cfg, dev)),
            batch_from_numpy(fields, dev))
    counts = _counts()
    check(counts["subm_conv_dgrad_bf16"] == 10
          and counts["sparse_wgrad_bf16"] == 11
          and counts["window_conv_bf16"] == 11
          and counts["subm_conv"] == counts["sparse_wgrad"] == 0,
          f"16b tiny bf16 train step launches {counts}")
    (ref_l, ref_g, ref_s), (losses, grads, stats) = runs["cpu"], runs[DEVICE]
    for k, v in losses.items():
        _, rel = rel_err(v, ref_l[k])
        check(rel <= BF16_TRAIN_TOL, f"16b loss {k}: rel err {rel}")
    worst_s = 0.0
    for k, v in stats.items():
        _, rel = rel_err(v, ref_s[k])
        check(rel <= BF16_TRAIN_TOL, f"16b statistic {k}: rel err {rel}")
        worst_s = max(worst_s, rel)
    dists = {}
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"16b gradient {k} not finite")
        dists[k] = rel_err(g, ref_g[k])[1]
    sparse = [k for k in grads if ".backbone3d." in k
              and k.endswith("conv.weight")]
    check(len(sparse) == 11 and all(torch.count_nonzero(grads[k]) > 0
                                    for k in sparse),
          "16b a sparse layer's weight gradient is zero")
    print(f"16b tiny bf16 train step, card vs CPU: losses "
          + ", ".join(f"{k} {v.item():.5f} ({rel_err(v, ref_l[k])[1]:.2e})"
                      for k, v in losses.items())
          + f"; {len(stats)} BN statistics max rel err {worst_s:.3e}; "
          f"launches {counts}; gradient leaves, distance of the largest "
          f"CPU value: " + ", ".join(f"{k} {v:.2e}" for k, v in
                                     sorted(dists.items())))
    return counts


def _split_micro_step(model, opt, batch) -> dict:
    """One more micro-step of ``make_train_step``'s body (train/
    train_state.py) with CUDA events at its span boundaries: {span: ms}
    for the forward, the losses, the backward and the non-finite guard
    with the accumulating update."""
    import torch
    from multimodal_gar_tpu_torch.models.layers import seed_dropout
    from multimodal_gar_tpu_torch.train.losses import (compute_losses,
                                                       total_loss)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    model.train()
    seed_dropout(model, 0, 10 ** 6)
    ev[0].record()
    out = model(batch)
    ev[1].record()
    loss = total_loss(compute_losses(out, batch), "L_total")
    ev[2].record()
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    ev[3].record()
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(opt.params, grads)]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    opt.update([torch.where(finite, g, 0.0) for g in grads])
    ev[4].record()
    ev[4].synchronize()
    names = ("forward", "losses", "backward", "guard + accumulation")
    return {n: round(ev[i].elapsed_time(ev[i + 1]), 3)
            for i, n in enumerate(names)}


def _bf16_micro_steps(fields16, x_window: bool) -> dict:
    """16c: 16 full-width bf16 micro-steps at the 16k cap, accumulation 8,
    on one sparse path, from phase 6's seeded weights and batch: each
    launches the bf16 stem once, the bf16 forward kernel of its path 11
    times, kernel C 10 times and kernel D 11 times and no float32 kernel;
    the loss finite, no gradient non-finite, the parameters moving at
    micro-steps 8 and 16 only. Micro-step ms by CUDA events, then one more
    bf16 and one float32 micro-step (the same weights) split into spans,
    with peak GiB (the float32 model's after one warm-up micro-step)."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import (make_optimizer,
                                                            make_train_step)
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, flagship_config, people_on_voxels, with_model)
    path = "x-window" if x_window else "nbr-map"
    want = dict(BF16_MICRO_STEP, **{("window_conv_bf16" if x_window
                                     else "subm_conv_bf16"): 11})
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = with_model(flagship_config(max_voxels=16000, dtype=dtype),
                         lidar=dict(x_window=x_window))
        accum = cfg.train.grad_accum_steps
        batch = batch_from_numpy(people_on_voxels(fields16, cfg), DEVICE)
        model = _model(cfg, DEVICE)
        opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                             steps_per_epoch=64, grad_accum=accum,
                             gamma=cfg.train.lr_decay_gamma)
        times = []
        if dtype == "bfloat16":
            step = make_train_step(model, opt, "L_total")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            prev = [p.detach().clone() for p in opt.params]
            for i in range(1, 2 * accum + 1):
                before = _counts()
                metrics, ms = _event_ms(lambda: step(batch))
                times.append(ms)
                ran = {k: _counts()[k] - before[k] for k in want}
                check(ran == want, f"16c {path} micro-step {i}: launches "
                      f"{ran}, expected {want}")
                loss = metrics["loss"].item()
                check(math.isfinite(loss)
                      and metrics["nonfinite_grads"].item() == 0.0,
                      f"16c {path} micro-step {i}: {metrics}")
                moved = any(not torch.equal(p, q)
                            for p, q in zip(opt.params, prev))
                check(moved == (i % accum == 0), f"16c {path} micro-step "
                      f"{i}: parameters moved {moved}")
                prev = [p.detach().clone() for p in opt.params]
            check(opt.updates == 2, f"16c {path}: {opt.updates} updates")
            counts = _counts()
        else:
            _split_micro_step(model, opt, batch)       # warm-up (cuDNN)
        split = _split_micro_step(model, opt, batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[dtype] = (times, split, peak)
        del model, opt, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    times, split, peak = out["bfloat16"]
    print(f"16c {path}, 16 bf16 micro-steps at full width (16k, "
          f"accumulation 8): ms by CUDA events {[round(t, 2) for t in times]}"
          f" (median {statistics.median(times[1:]):.2f} after the first), "
          f"launches per micro-step {want}, loss finite, parameters moved "
          f"at 8 and 16 only; one more micro-step split {split}, peak "
          f"{peak:.2f} GiB; float32 micro-step split {out['float32'][1]}, "
          f"peak {out['float32'][2]:.2f} GiB")
    return counts


def _bf16_trainable_i3d(fields16) -> dict:
    """16d: two full-width bf16 micro-steps with a trainable I3D: its stem
    through F.conv3d on bf16 operands (no stem kernel of either dtype),
    finite and non-zero gradients on the I3D's parameters."""
    import torch
    from multimodal_gar_tpu_torch.train.train_state import (make_optimizer,
                                                            make_train_step)
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, flagship_config, people_on_voxels, with_model)
    cfg = with_model(flagship_config(max_voxels=16000, dtype="bfloat16"),
                     rgb=dict(i3d_freeze=False))
    batch = batch_from_numpy(people_on_voxels(fields16, cfg), DEVICE)
    model = _model(cfg, DEVICE)
    opt = make_optimizer(model.parameters(), cfg.train.stages[0],
                         steps_per_epoch=64,
                         grad_accum=cfg.train.grad_accum_steps,
                         gamma=cfg.train.lr_decay_gamma)
    step = make_train_step(model, opt, "L_total")
    _reset_counts()
    times = []
    for i in range(2):
        metrics, ms = _event_ms(lambda: step(batch))
        times.append(ms)
        check(math.isfinite(metrics["loss"].item())
              and metrics["nonfinite_grads"].item() == 0.0,
              f"16d micro-step {i}: {metrics}")
    counts = _counts()
    check(counts["stem_conv"] == counts["stem_conv_bf16"] == 0
          and counts["subm_conv_dgrad_bf16"] == 20
          and counts["sparse_wgrad_bf16"] == 22,
          f"16d trainable I3D launches {counts}")
    i3d = dict(model.rgb_backbone.i3d.named_parameters())
    _, grads, _ = _loss_terms_and_grads(model, batch)
    grads = {k: grads[f"rgb_backbone.i3d.{k}"] for k in i3d}
    check(all(bool(torch.isfinite(g).all()) for g in grads.values())
          and torch.count_nonzero(grads["Conv3d_1a_7x7.conv3d.weight"]) > 0,
          "16d: an I3D gradient is not finite, or the stem's is zero")
    print(f"16d trainable I3D at bf16, 2 micro-steps: ms by CUDA events "
          f"{[round(t, 2) for t in times]}, launches {counts}; "
          f"{len(grads)} I3D gradients finite, the stem's non-zero")
    return counts


def _bf16_det_train(name: str, x_window: bool) -> dict:
    """16e: b2 train steps of a detector at KITTI's widths at bf16, each
    launching BF16_DET_STEP[name] and no float32 sparse kernel, the loss
    finite; every bf16 sparse launch of one step recorded and replayed
    against its plain version (_bf16_replay: kernel D twice for equal
    bits); step ms beside the float32 step's."""
    import torch
    import multimodal_gar_tpu_torch.ops.kernels.subm_conv as k3m
    want = {**BF16_DET_STEP[name], "subm_conv": 0, "window_conv": 0,
            "sparse_wgrad": 0}
    batch = _det_batch(name, [0, 1], x_window=x_window)
    model = _det_model(name, dtype="bfloat16", x_window=x_window)
    _reset_counts()
    times, loss = _train(model, batch, want, f"16e {name} bf16", steps=3)
    counts = _counts()

    def step():
        model.train()
        model.loss(model(batch), batch)["loss"].backward()
        model.zero_grad(set_to_none=True)
    calls, kernels = _recorded_launches(step, dict(
        _sparse_sites(), subm_conv_dgrad_bf16=(
            k3m, "subm_conv_dgrad_bf16", k3m.subm_conv_dgrad_bf16_plain)))
    seen = {_BF16_SITE[k]: sum(c[0] == k for c in calls) for k in kernels}
    check({k: n for k, n in seen.items() if n} == BF16_DET_STEP[name]
          and all(a[0].dtype == torch.bfloat16 for _, a in calls),
          f"16e {name}: recorded bf16 launches {seen}")
    _bf16_replay(calls, kernels, f"16e {name} b2 step")
    ref_times, _ = _train(
        _det_model(name, x_window=x_window), batch,
        {"sparse_wgrad": BF16_DET_STEP[name]["sparse_wgrad_bf16"]},
        f"16e {name} float32", steps=2)
    print(f"16e {name} ({'x-window' if x_window else 'nbr-map'}) bf16 b2 "
          f"train steps: ms by CUDA events {[round(t, 2) for t in times]} "
          f"against float32 {[round(t, 2) for t in ref_times]} (the first "
          f"of each times cuDNN), loss {loss:.4f}; launches per step "
          f"{BF16_DET_STEP[name]}")
    return counts


def _bf16_cli_train() -> dict:
    """16f, the command line: ``train --set model.dtype=bfloat16
    --max-steps-per-epoch 2`` through ``main`` on the card by default, on a
    small on-disk synthetic JRDB (data/synthetic.py, as 15f) with one stage
    of one epoch, then ``eval`` of its checkpoint at
    float32 and at bf16; the bf16 training kernels launch and every
    metric is finite."""
    import torch
    import yaml
    from multimodal_gar_tpu_torch.__main__ import main
    from multimodal_gar_tpu_torch.config import config_to_dict
    from multimodal_gar_tpu_torch.data.synthetic import write_synthetic_jrdb
    from multimodal_gar_tpu_torch.utils.testing import tiny_config
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_jrdb(os.path.join(root, "jrdb"), num_seqs=1,
                             frames_per_seq=3, people_per_frame=4,
                             image_hw=(48, 80))
        cfg = tiny_config(num_people=6, image_hw=(48, 80))
        # one stage of one epoch: the path, not the schedule
        stage = dataclasses.replace(cfg.train.stages[0], epochs=1)
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          root=os.path.join(root, "jrdb")),
            train=dataclasses.replace(cfg.train, stages=(stage,)))
        path = os.path.join(root, "tiny.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(json.loads(json.dumps(config_to_dict(cfg))), f)
        work = os.path.join(root, "work")
        common = ["--config", path, "--workdir", work]
        _reset_counts()
        t0 = time.perf_counter()
        check(main(["train", *common, "--set", "model.dtype=bfloat16",
                    "--max-steps-per-epoch", "2"]) == 0,
              "16f: the CLI's train at bf16 failed")
        seconds = time.perf_counter() - t0
        counts = _counts()
        check(counts["subm_conv_dgrad_bf16"] > 0
              and counts["sparse_wgrad_bf16"] > 0
              and counts["sparse_wgrad"] == 0,
              f"16f: the CLI's bf16 training launches {counts}")
        ckpts = sorted(n for n in os.listdir(os.path.join(work,
                                                          "checkpoints"))
                       if n.endswith(".pt"))
        check(ckpts, "16f: the CLI's bf16 training wrote no checkpoint")
        state = torch.load(os.path.join(work, "checkpoints", ckpts[-1]),
                           map_location="cpu", weights_only=False)["model"]
        check(all(v.dtype == torch.float32 for v in state.values()
                  if v.is_floating_point()),
              "16f: a checkpoint tensor is not float32")
        for over in ([], ["--set", "model.dtype=bfloat16"]):
            before = _counts()
            check(main(["eval", *common, *over]) == 0,
                  f"16f: the CLI's eval {over} of the bf16-trained "
                  f"checkpoint failed")
            stem = "stem_conv_bf16" if over else "stem_conv"
            check(_counts()[stem] > before[stem],
                  f"16f: eval {over} launched no {stem}")
        counts = _counts()
    print(f"16f `python -m multimodal_gar_tpu_torch train --set "
          f"model.dtype=bfloat16` on a synthetic JRDB: {seconds:.1f} s, "
          f"checkpoint {ckpts[-1]} of float32 tensors, served by `eval` at "
          f"float32 and at bf16; launches {counts}")
    return counts


def _bf16_learning_check() -> dict:
    """16g: 13g's MGAR learning check at bf16 (utils/testing.py:
    overfit_mgar, the same seed-0 init and batch), held to 13g's own gate:
    the eval L_total falls at least 5 times, with train-set grouping AP
    1."""
    from multimodal_gar_tpu_torch.utils.testing import overfit_mgar
    _reset_counts()
    t0 = time.perf_counter()
    r = overfit_mgar(device="cuda", fall=5.0, dtype="bfloat16")
    seconds = time.perf_counter() - t0
    counts = _counts()
    print(f"16g learning check at bf16 on the card: MGAR at tiny_config, "
          f"eval L_total {r['loss0']:.4f} -> {r['loss']:.4f} in "
          f"{r['steps']} steps, {seconds:.1f} s, train-set group AP "
          f"{r['group_ap']:.3f}; launches {counts}")
    check(r["loss"] <= r["loss0"] / 5 and abs(r["group_ap"] - 1.0) < 1e-6,
          f"16g MGAR did not overfit at bf16: {r}")
    return counts


def phase_bf16_training(fields16) -> dict:
    """16b-16g; returns the launch counts of the paths they drive."""
    totals = {}
    runs = [timed("16b tiny bf16 train step, card vs CPU",
                  _bf16_tiny_train_card_vs_cpu),
            timed("16c x-window micro-steps", _bf16_micro_steps, fields16,
                  True),
            timed("16c nbr-map micro-steps", _bf16_micro_steps, fields16,
                  False),
            timed("16d trainable I3D", _bf16_trainable_i3d, fields16)]
    for name, xw in (("SECOND", False), ("CenterPoint", True),
                     ("PartA2", True), ("VoxelNeXt", False)):
        runs.append(timed(f"16e {name}", _bf16_det_train, name, xw))
    runs += [timed("16f CLI", _bf16_cli_train),
             timed("16g learning check", _bf16_learning_check)]
    for counts in runs:
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
    return totals


def main() -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep", action="store_true",
                        help="phase 8 also times the decode pool's "
                             "transport and the pipeline alone, and trains "
                             "with 8 workers (several minutes more)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_gar_tpu_torch.utils.testing import (
        clustered_rulebook_numpy, flagship_config, synthetic_batch_numpy)
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        stem = phase_stem(gen)
        t0 = time.perf_counter()
        cfg = flagship_config()
        fields = synthetic_batch_numpy(cfg, batch_size=1, seed=0, n_valid=100)
        cfg16 = flagship_config(max_voxels=16000)
        fields16 = synthetic_batch_numpy(cfg16, batch_size=1, seed=0,
                                         n_valid=100)
        clustered = clustered_rulebook_numpy(cfg)
        clustered16 = clustered_rulebook_numpy(cfg16)
        clustered16_rb = {"rulebook": clustered16["rulebook"]}
        print(f"flagship synthetic batches + rulebooks (40k, 16k voxels) and "
              f"the clustered 40k and 16k rulebooks: "
              f"{time.perf_counter() - t0:.1f} s")
        caps = cfg.model.lidar.max_voxels_per_stage
        window = phase_window(
            {"synthetic": fields["rulebook"],
             "clustered": clustered["rulebook"]}, caps, gen)
        clustered_rb = clustered["rulebook"]
        del clustered
        k3, k4 = phase_subm_wgrad(
            fields, caps, fields16, clustered16,
            cfg16.model.lidar.max_voxels_per_stage, gen)
        del clustered16
        # 3d: xyz-only points, width 3 padded to the (4, 16) instances
        width3_errs, width3_keys = timed(
            "3d input width 3", _input_width_launches, fields16, gen,
            DEVICE, (3,), "3d", "width_3")
        gather, shifted = phase_probe_kernels(k3)
        ngather = timed("3e neighbour_gather", phase_neighbour_gather, gen)
        nms = timed("3f the NMS kernels", phase_nms)
    timed("tiny forward, card vs CPU", phase_tiny)
    timed("36 variants, card vs CPU", phase_variants)
    timed("tiny train step, card vs CPU", phase_tiny_train)
    eval_counts, xw_out = timed("3 x-window requests", phase_full, fields)
    nbr_counts = timed("3 nbr-map requests", phase_full_nbr, fields, xw_out)
    del xw_out
    train_counts = timed("16 train micro-steps", phase_train, fields16)
    cfg_counts, step_device_s = timed(
        "6 shipped configs at full width", phase_configs, fields, fields16)
    tool_counts = timed("probe tool", phase_probe_tool)
    cli_counts = timed("the CLI: run_training, run_eval, resume", phase_cli,
                       step_device_s, args.sweep)
    switch_counts = timed("switches", phase_switches, fields, fields16)
    det_counts, det_errs = timed("detectors", phase_detectors)
    slice2_counts, slice2_errs = timed("the zoo's second slice",
                                       phase_second_slice)
    model_side_counts, model_side_errs = timed(
        "CaDDN, MPPNet, the extras, the 2D backbones", phase_model_side)
    data_counts, data_errs = timed("the datasets, a nuScenes CenterPoint",
                                   phase_datasets)
    par_counts, par_errs, width_keys = timed(
        "the parallel layer, input widths 9-15", phase_parallel, cfg16,
        fields16)
    t15 = time.perf_counter()
    with torch.inference_mode():
        stem16 = phase_bf16_stem(gen)
        window16, subm16 = phase_bf16_sparse(
            {"synthetic": fields["rulebook"], "clustered": clustered_rb},
            caps, gen)
    bf16_counts = phase_bf16_serving(fields)
    print(f"phase [15: bf16 serving, 15f in phase 8]: "
          f"{time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    with torch.inference_mode():
        dgrad16, wgrad16 = timed(
            "16a kernels C and D", phase_bf16_grad_kernels, fields16,
            clustered16_rb, cfg16.model.lidar.max_voxels_per_stage, gen)
    train16_counts = phase_bf16_training(fields16)
    print(f"phase [16: bf16 training]: {time.perf_counter() - t16:.1f} s")
    det_errs = _worst(det_errs, slice2_errs, model_side_errs, data_errs,
                      par_errs, width3_errs)
    paths = (eval_counts, nbr_counts, train_counts, cfg_counts, tool_counts,
             cli_counts, switch_counts, det_counts, slice2_counts,
             model_side_counts, data_counts, par_counts, bf16_counts,
             train16_counts)
    launches = {k: sum(c.get(k, 0) for c in paths) for k in eval_counts}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main paths never launched: {launches}")
    probe = "tools/probe_gather.py"
    kernels = [
        {"name": "stem_conv", "route": "cuda", "source": f"{SRC}/stem_conv.cu",
         "replaces": "multimodal_gar_tpu/ops/pallas/stem_conv.py:390",
         "launches": launches["stem_conv"], **stem},
        {"name": "window_conv", "route": "cuda",
         "source": f"{SRC}/window_conv.cu",
         "replaces": "multimodal_gar_tpu/ops/pallas/window_conv.py:220",
         "launches": launches["window_conv"], **window},
        {"name": "subm_conv", "route": "cuda", "source": f"{SRC}/subm_conv.cu",
         "replaces": f"multimodal_gar_tpu/ops/pallas/subm_conv.py:69, "
                     f"{probe}:113",
         "launches": launches["subm_conv"], **k3.entry()},
        {"name": "sparse_wgrad", "route": "cuda",
         "source": f"{SRC}/sparse_wgrad.cu",
         "replaces": "multimodal_gar_tpu/models/sparse_backbone.py:172",
         "launches": launches["sparse_wgrad"], **k4},
        {"name": "row_gather", "route": "cuda",
         "source": f"{SRC}/row_gather.cu",
         "replaces": f"{probe}:78, {probe}:220",
         "launches": launches["row_gather"], **gather.entry()},
        {"name": "window_conv_shifted", "route": "cuda",
         "source": f"{SRC}/window_conv.cu", "replaces": f"{probe}:277",
         "launches": launches["window_conv_shifted"], **shifted.entry()},
        {"name": "neighbour_gather", "route": "cuda",
         "source": f"{SRC}/neighbour_gather.cu",
         "replaces": "multimodal_gar_tpu/models/roi_grid_pool.py:125",
         "launches": launches["neighbour_gather"], **ngather.entry()},
        {"name": "nms_bev", "route": "cuda", "source": f"{SRC}/nms_bev.cu",
         "replaces": "multimodal_gar_tpu/ops/boxes3d.py:146",
         "launches": launches["nms_bev_words"] + launches["nms_sweep"],
         "words_launches": launches["nms_bev_words"],
         "sweep_launches": launches["nms_sweep"], **nms.entry()},
    ]
    for entry in kernels:
        # the errors of the detectors' launches (phases 10-13) count too
        err, rel = det_errs.get(entry["name"], (0.0, 0.0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["max_rel_err"] = max(entry["max_rel_err"], rel)
        entry.update(width_keys.get(entry["name"], {}))
        entry.update(width3_keys.get(entry["name"], {}))
    # phase 15: the bf16 kernels, held to their plain versions in bf16 ulps
    sbb = "multimodal_gar_tpu/models/sparse_backbone.py"
    kernels += [
        {"name": "stem_conv_bf16", "route": "cuda",
         "source": f"{SRC}/stem_conv.cu",
         "replaces": "multimodal_gar_tpu/models/i3d.py:290",
         "launches": launches["stem_conv_bf16"], **stem16},
        {"name": "window_conv_bf16", "route": "cuda",
         "source": f"{SRC}/window_conv.cu",
         "replaces": f"{sbb}:172, {sbb}:298",
         "launches": launches["window_conv_bf16"], **window16},
        {"name": "subm_conv_bf16", "route": "cuda",
         "source": f"{SRC}/subm_conv.cu",
         "replaces": f"{sbb}:172, {sbb}:298",
         "launches": launches["subm_conv_bf16"], **subm16},
        # phase 16: the bf16 backward (XLA's VJP of the gather + einsum)
        {"name": "subm_conv_dgrad_bf16", "route": "cuda",
         "source": f"{SRC}/subm_conv.cu",
         "replaces": f"{sbb}:162, {sbb}:172, {sbb}:298",
         "launches": launches["subm_conv_dgrad_bf16"], **dgrad16},
        {"name": "sparse_wgrad_bf16", "route": "cuda",
         "source": f"{SRC}/sparse_wgrad.cu",
         "replaces": f"{sbb}:172, {sbb}:298",
         "launches": launches["sparse_wgrad_bf16"], **wgrad16},
    ]
    # the wide pairs (15e, 16e, 12g): each pair's launches, graph-replayed
    # ms and bf16 bound; the errors of every bf16 replay there count too
    for (name, pair), (n, ms, bnd_ms, most) in sorted(WIDE_PAIRS.items()):
        print(f"wide pair {name} {pair}: {n} launches replayed, "
              f"{ms / n:.4f} ms a launch from a CUDA graph, bound "
              f"{bnd_ms / n:.4f} ms ({bnd_ms / ms:.1%})"
              + (f", share differing {most:.3e}"
                 if name == "subm_conv_dgrad_bf16"
                 else f", most {most:g} ulps apart"))
    for entry in kernels:
        if entry["name"] in BF16_FIRST_PAIRS:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       BF16_REPLAY_ERR.get(entry["name"],
                                                           0.0))
            rows = [v for (k, _), v in WIDE_PAIRS.items()
                    if k == entry["name"]]
            if rows:
                entry["wide_pairs_graph_ms"] = sum(r[1] for r in rows)
                entry["wide_pairs_bound_ms"] = sum(r[2] for r in rows)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
