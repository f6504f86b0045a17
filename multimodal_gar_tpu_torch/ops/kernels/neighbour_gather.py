"""The grid pool's neighbour gather, with a hand-written backward.

``neighbour_gather(f, rows, keep)``: f (B, M, C) voxel features, rows
(B, R, S) the voxel rows of each query's S neighbours, keep (B, R) bool ->
(B, R, S, C) equal to ``f[bidx, rows] * keep[..., None, None]``
(models/roi_grid_pool.py). The forward is that plain expression, so its
bits are those of advanced indexing. The backward sums, for each voxel
row, the upstream gradient of the kept entries that gathered it:

- on the card, ``csrc/neighbour_gather.cu``: the wrapper builds an
  inverse map (each kept entry keyed ``b * M + row``, masked entries
  ``B * M``, ordered by a stable sort; each row's first sorted position
  by a search), and one segmented-sum kernel writes every row of dF once,
  each row's entries added in sorted order (flat-position order), rows
  longer than the kernel's chunk (256 entries) split into chunks whose
  partials are added in chunk order. No float atomics: two calls give the
  same bits. float32 only (the masked BatchNorm before the gather returns
  float32 at either model dtype); anything else raises;
- on the CPU, ``neighbour_gather_backward_plain``: the same sum through
  ``index_put_`` with accumulation, advanced indexing's own backward.

Masked entries are dropped, not multiplied by zero: where the upstream
gradient of a masked entry is inf or NaN the gather's old graph sent NaN
(0 x inf) into f's gradient, and this backward does not. A finite loss
sees no difference; a non-finite one still reaches the other leaves.

Replaces no Pallas kernel (the JAX grid pool gathers with XLA's gather and
one-hot einsum, multimodal_gar_tpu/models/roi_grid_pool.py:125-139). The
backward is bound by bytes: the kept rows read (kept x C x 4), dF written
(B x M x C x 4) and the map. It replaces PyTorch's sort-based index_put_,
whose serial loop over each duplicated index ran the padded boxes' 138k to
311k masked entries a scale, all on one voxel row, one after another.

``neighbour_gather.launches`` counts the kernel's launches;
``neighbour_gather.stats(device)`` reads how often the mechanism engages
(entries and kept entries summed over the backward calls, the longest row),
which the kernel adds to a device buffer in the same launch and the CPU
path by one ``bincount``; reading it synchronises with the device, so only
tests and tools call it.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ._build import KernelLibrary, stream_handle


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgar_neighbour_gather_bwd_f32.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, ctypes.c_longlong, p]
    lib.mgar_neighbour_gather_bwd_f32.restype = ctypes.c_int
    lib.mgar_neighbour_gather_chunk.argtypes = []
    lib.mgar_neighbour_gather_chunk.restype = ctypes.c_int
    # sorted positions per scratch partial: a constant of the build
    lib.chunk = lib.mgar_neighbour_gather_chunk()


LIBRARY = KernelLibrary("neighbour_gather", _bind)

# per device: int64 [entries, kept entries, longest row] that each
# backward adds to
_STATS: Dict[torch.device, torch.Tensor] = {}


def _stats(device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _STATS:
        _STATS[device] = torch.zeros(3, dtype=torch.int64, device=device)
    return _STATS[device]


def _forward(f: torch.Tensor, rows: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    bidx = torch.arange(rows.shape[0], device=rows.device)[:, None, None]
    return f[bidx, rows] * keep[..., None, None].to(f.dtype)


def inverse_map(rows: torch.Tensor, keep: torch.Tensor, m: int):
    """The backward's map: (skey (N,) int32 sorted keys, perm (N,) int64
    the flat entry (b, r, s) at each sorted position, off (B*M + 1,) int32
    each row's first sorted position; off[B*M] is the kept count). A kept
    entry's key is ``b * M + row``, a masked one's ``B * M``; the sort is
    stable, so a row's entries keep their flat order."""
    b = rows.shape[0]
    base = torch.arange(0, b * m, m, dtype=torch.int32,
                        device=rows.device).view(b, 1, 1)
    keys = torch.where(keep[:, :, None], rows.to(torch.int32) + base, b * m)
    skey, perm = torch.sort(keys.reshape(-1), stable=True)
    off = torch.searchsorted(
        skey, torch.arange(b * m + 1, dtype=torch.int32, device=rows.device),
        out_int32=True)
    return skey, perm, off


def neighbour_gather_backward_plain(dout: torch.Tensor, rows: torch.Tensor,
                                    keep: torch.Tensor,
                                    m: int) -> torch.Tensor:
    """dF (B, M, C): the kept entries' dOut rows summed into their voxel
    rows by ``index_put_`` with accumulation (masked entries add zero)."""
    b, c = rows.shape[0], dout.shape[-1]
    bidx = torch.arange(b, device=rows.device)[:, None, None]
    g = torch.where(keep[:, :, None, None], dout, 0.0)
    return dout.new_zeros((b, m, c)).index_put_(
        (bidx.expand_as(rows), rows.long()), g, accumulate=True)


def _check(f, rows, keep):
    if f.ndim != 3 or rows.ndim != 3 or keep.shape != rows.shape[:2] \
            or rows.shape[0] != f.shape[0]:
        raise ValueError(f"f (B, M, C), rows (B, R, S) and keep (B, R) "
                         f"expected, got {tuple(f.shape)}, "
                         f"{tuple(rows.shape)}, {tuple(keep.shape)}")
    if keep.dtype != torch.bool:
        raise TypeError("keep must be bool")
    if rows.dtype not in (torch.int32, torch.int64):
        raise TypeError("rows must be int32 or int64")
    if not f.device == rows.device == keep.device:
        raise ValueError("neighbour_gather inputs must share one device")
    b, m = f.shape[:2]
    if b * m >= 2 ** 31 - 1 or rows.numel() >= 2 ** 31 - 1:
        raise ValueError("neighbour_gather keys and entries are int32")


def launch_kernel(dout, skey, perm, off, df, scratch, count,
                  stats) -> None:
    """One launch over a map made beforehand (``inverse_map``): dout
    contiguous float32 (N rows of C), df (B, M, C) written whole, scratch
    (2, windows, C) and count (windows,) int32 zeros, windows = ceil(N /
    chunk), stats the int64 [entries, kept, longest] the launch adds
    to."""
    b, m, c = df.shape
    err = LIBRARY.load().mgar_neighbour_gather_bwd_f32(
        dout.data_ptr(), perm.data_ptr(), skey.data_ptr(), off.data_ptr(),
        df.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        count.data_ptr(), stats.data_ptr(), b * m, c, perm.numel(),
        stream_handle(dout.device))
    if err != 0:
        raise RuntimeError(f"neighbour_gather kernel launch failed: CUDA "
                           f"error {err}")
    neighbour_gather.launches += 1


def _backward_kernel(dout, rows, keep, m, stats):
    """dF (B, M, C) on the card: the inverse map, then one launch."""
    if dout.dtype != torch.float32:
        raise TypeError(f"the neighbour_gather kernel takes float32, got "
                        f"{dout.dtype}")
    b, c = rows.shape[0], dout.shape[-1]
    dout = dout.contiguous()
    df = dout.new_empty((b, m, c))
    if b * m == 0:
        return df
    skey, perm, off = inverse_map(rows, keep, m)
    windows = -(-perm.numel() // LIBRARY.load().chunk)
    launch_kernel(dout, skey, perm, off, df, dout.new_empty((2, windows, c)),
                  torch.zeros(windows, dtype=torch.int32, device=dout.device),
                  stats)
    return df


def neighbour_gather_backward(dout: torch.Tensor, rows: torch.Tensor,
                              keep: torch.Tensor, m: int) -> torch.Tensor:
    """dF (B, M, C) of the gather: the kernel for CUDA tensors, the plain
    version for CPU tensors; both add to the device's stats."""
    if dout.device.type not in ("cpu", "cuda"):
        raise ValueError(f"neighbour_gather runs on cpu or cuda, not "
                         f"{dout.device}")
    stats = _stats(dout.device)
    if dout.device.type == "cuda":
        return _backward_kernel(dout, rows, keep, m, stats)
    b = rows.shape[0]
    kept = keep[:, :, None].expand(rows.shape)
    keys = (rows + torch.arange(0, b * m, m)[:, None, None])[kept]
    stats[0] += rows.numel()
    stats[1] += keys.numel()
    if keys.numel():
        stats[2] = torch.maximum(stats[2], torch.bincount(keys).max())
    return neighbour_gather_backward_plain(dout, rows, keep, m)


class _NeighbourGather(torch.autograd.Function):
    """The plain gather forward; rows (as int32) and keep saved for the
    backward, which returns d(f) alone."""

    @staticmethod
    def forward(ctx, f, rows, keep):
        ctx.save_for_backward(rows.to(torch.int32), keep)
        ctx.m = f.shape[1]
        return _forward(f, rows, keep)

    @staticmethod
    def backward(ctx, dout):
        rows, keep = ctx.saved_tensors
        return neighbour_gather_backward(dout, rows, keep, ctx.m), None, None


def neighbour_gather(f: torch.Tensor, rows: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """``f[bidx, rows] * keep[..., None, None]``: f (B, M, C), rows
    (B, R, S) int32 or int64 in [0, M), keep (B, R) bool -> (B, R, S, C).
    Where f needs a gradient, through the Function whose backward is the
    kernel on the card; else the plain expression alone."""
    _check(f, rows, keep)
    if not (torch.is_grad_enabled() and f.requires_grad):
        return _forward(f, rows, keep)
    return _NeighbourGather.apply(f, rows, keep)


def stats(device) -> dict:
    """Since the last :func:`reset_stats` on ``device``, over the backward
    calls: ``entries`` (B*R*S summed), ``kept`` entries and the ``longest``
    row (most kept entries on one voxel row in a call). Synchronises with
    the device."""
    return dict(zip(("entries", "kept", "longest"),
                    _stats(device).tolist()))


def reset_stats(device) -> None:
    """Zero ``device``'s stats."""
    _stats(device).zero_()


neighbour_gather.launches = 0
neighbour_gather.stats = stats
neighbour_gather.reset_stats = reset_stats
