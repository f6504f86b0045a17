"""The greedy rotated-BEV NMS over suppression words (ops/boxes3d.py:
``nms_bev``, ``circle_nms``).

Boxes come sorted by descending score. ``words`` (N, W) int64, W =
ceil(N / 64), hold the upper triangle of the suppression relation: bit b of
``words[i, w]`` says that box i, if kept, suppresses box j = 64 w + b > i.
The sweep keeps box i iff it is valid and no kept box before it sets its
bit. 8 bytes a word: 10.2 MB at N = 9000, where the N x N IoU matrix and its
clip buffers took gigabytes.

- ``bev_words``: the words of the rotated BEV IoU above a threshold. On the
  card the kernel ``csrc/nms_bev.cu: nms_bev_words_kernel``; on the CPU
  ``bev_words_plain``, the same pairs in blocks of 64 rows with
  ops/boxes3d.py's torch clip. Both clip only the pairs whose circumscribed
  circles meet, and count them and the pairs that truly overlap into two
  int64 counters (``clip_pairs``, ``overlap_pairs``).
- ``pack_words``: words from a (rows, N) boolean block (circle NMS's).
- ``sweep``: the keep mask, on the card ``nms_sweep_kernel`` (one block,
  no host synchronisation), on the CPU ``sweep_plain`` (a loop over the
  boxes).

Both kernels are deterministic and launch on the current stream without a
synchronisation; ``bev_words.launches`` and ``sweep.launches`` count them.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._build import KernelLibrary, stream_handle

BLOCK = 64
# the sweep holds one word of each 64 boxes in 48 KB of shared memory
MAX_BOXES = 64 * 6144


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_nms_bev_words.argtypes = [p, i, ctypes.c_float, p, p, p]
    lib.mgar_nms_bev_words.restype = ctypes.c_int
    lib.mgar_nms_sweep.argtypes = [p, p, i, p, p]
    lib.mgar_nms_sweep.restype = ctypes.c_int


LIBRARY = KernelLibrary("nms_bev", _bind)


def num_words(n: int) -> int:
    return -(-n // BLOCK)


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(R, N) bool -> (R, ceil(N / 64)) int64, bit b of word w = column
    64 w + b (a sum of distinct powers of two: exact, bit 63 included)."""
    r, n = bits.shape
    w = num_words(n)
    padded = torch.zeros((r, w * BLOCK), dtype=torch.int64,
                         device=bits.device)
    padded[:, :n] = bits
    shifts = torch.arange(BLOCK, dtype=torch.int64, device=bits.device)
    return (padded.view(r, w, BLOCK) << shifts).sum(-1)


def _circles_meet(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 7) x (N, 7) -> (R, N): the boxes' circumscribed BEV circles meet,
    with the kernel's room for rounding."""
    ra = 0.5 * torch.sqrt(a[:, 3] ** 2 + a[:, 4] ** 2)
    rb = 0.5 * torch.sqrt(b[:, 3] ** 2 + b[:, 4] ** 2)
    d2 = (b[None, :, 0] - a[:, None, 0]) ** 2 \
        + (b[None, :, 1] - a[:, None, 1]) ** 2
    rs = ra[:, None] + rb[None, :]
    return d2 <= rs * rs * 1.0001 + 1e-6


def bev_words_plain(boxes: torch.Tensor, thr: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The suppression words of sorted ``boxes`` (N, 7) in blocks of 64
    rows, each pair's IoU that of ``boxes3d.boxes_iou_bev(a=later box,
    b=earlier box)``; and the counters (clip_pairs, overlap_pairs)."""
    from ..boxes3d import _bev_corners, _pair_overlap_bev
    n = boxes.shape[0]
    later = torch.arange(n, device=boxes.device)
    out, clipped, overlapping = [], 0, 0
    for s in range(0, n, BLOCK):
        rows = boxes[s:s + BLOCK]
        cand = _circles_meet(rows, boxes) \
            & (later[None, :] > later[s:s + BLOCK, None])
        ri, ci = cand.nonzero(as_tuple=True)
        a, b = boxes[ci], rows[ri]
        inter = _pair_overlap_bev(_bev_corners(a), _bev_corners(b))
        union = a[:, 3] * a[:, 4] + b[:, 3] * b[:, 4] - inter
        hit = torch.zeros_like(cand)
        hit[ri, ci] = inter / union.clamp(min=1e-9) > thr
        out.append(pack_words(hit))
        clipped += int(ri.numel())
        overlapping += int((inter > 0).sum())
    words = torch.cat(out) if out else torch.zeros(
        (0, 0), dtype=torch.int64, device=boxes.device)
    return words, torch.tensor([clipped, overlapping])


def sweep_plain(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask in sorted order, one box at a time."""
    n = words.shape[0]
    rows = words.numpy().view(np.uint64)
    dead = np.zeros(num_words(n) * BLOCK, bool)
    dead[:n] = ~valid.numpy()
    removed = pack_words(torch.from_numpy(dead[None]))[0].numpy().view(
        np.uint64).copy()
    keep = np.zeros(n, bool)
    for i in range(n):
        if not (int(removed[i // BLOCK]) >> (i % BLOCK)) & 1:
            keep[i] = True
            removed |= rows[i]
    return torch.from_numpy(keep)


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("the NMS kernels take contiguous CUDA tensors")


def bev_words(boxes: torch.Tensor, thr: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The suppression words of ``boxes`` (N, 7) float32, sorted by
    descending score, for BEV IoU > ``thr``, and the int64 counters
    (clip_pairs, overlap_pairs) on the boxes' device: the kernel on the
    card, ``bev_words_plain`` on the CPU."""
    if boxes.ndim != 2 or boxes.shape[1] < 7:
        raise ValueError(f"boxes (N, 7+) expected, got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return bev_words_plain(boxes[:, :7], thr)
    if boxes.dtype != torch.float32:
        raise TypeError("the NMS kernel takes float32 boxes")
    boxes = boxes[:, :7].contiguous()
    _check_cuda(boxes)
    n = boxes.shape[0]
    words = torch.empty((n, num_words(n)), dtype=torch.int64,
                        device=boxes.device)
    counters = torch.zeros(2, dtype=torch.int64, device=boxes.device)
    err = LIBRARY.load().mgar_nms_bev_words(
        boxes.data_ptr(), n, float(thr), words.data_ptr(),
        counters.data_ptr(), stream_handle(boxes.device))
    if err != 0:
        raise RuntimeError(f"nms_bev_words kernel launch failed: CUDA "
                           f"error {err}")
    bev_words.launches += 1
    return words, counters


def sweep(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The keep mask (N,) bool in sorted order from ``words`` (N, W) int64
    and ``valid`` (N,) bool in sorted order: the kernel on the card,
    ``sweep_plain`` on the CPU."""
    n = words.shape[0]
    if words.shape != (n, num_words(n)) or valid.shape != (n,):
        raise ValueError(f"words (N, {num_words(n)}) and valid (N,) "
                         f"expected, got {tuple(words.shape)}, "
                         f"{tuple(valid.shape)}")
    if words.device.type == "cpu":
        return sweep_plain(words, valid)
    if n > MAX_BOXES:
        raise ValueError(f"the sweep kernel takes at most {MAX_BOXES} boxes")
    valid = valid.to(torch.bool).contiguous()
    _check_cuda(words, valid)
    keep = torch.empty(n, dtype=torch.bool, device=words.device)
    err = LIBRARY.load().mgar_nms_sweep(
        words.data_ptr(), valid.data_ptr(), n, keep.data_ptr(),
        stream_handle(words.device))
    if err != 0:
        raise RuntimeError(f"nms_sweep kernel launch failed: CUDA error "
                           f"{err}")
    sweep.launches += 1
    return keep


bev_words.launches = 0
sweep.launches = 0
