"""Row-gather and fused sparse-conv probes on the card.

The counterpart of ``tools/probe_gather.py``, which asked whether a TPU
kernel can gather rows of a VMEM-resident table at all. On the card a thread
loads any address, so the probes here ask what the port's hand-written
kernels cost beside plain PyTorch on the same inputs. Letters as in the
original:

  C. plain gather + einsum (advanced indexing, then the 27-tap product);
  D. the cost of plain torch row gathers by rows per query and row width;
  A. the row-gather kernel, 27 rows per query (ops/kernels/row_gather.py);
  B. gather + per-tap GEMM: the index-map sparse conv kernel at B = 1
     (ops/kernels/subm_conv.py; the same function as the original's B);
  W. the x-window sparse conv kernel (ops/kernels/window_conv.py) against
     window_gather + einsum, with the relative error;
  E. the row-gather kernel, one row per query, at four table shapes;
  F. the 9-slot x-window conv over a pre-shifted table
     (ops/kernels/window_conv.py: window_conv_shifted).

Each probe is a function that takes its sizes, makes its inputs from
``np.random.default_rng(0)`` as the original does, checks the kernel against
the plain version and returns its numbers. On the card a time is the median
of 10 runs after 3 warm-ups between CUDA events; with ``--device cpu`` the
wrappers take their plain versions and the times are host-clock times of
those (a check that the tool runs, not a measurement). A probe that fails
raises and fails the run.

Usage: python3 -m multimodal_gar_tpu_torch.tools.probe_gather
           [--device cpu] [--rows N]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from ..ops.kernels.row_gather import row_gather, row_gather_plain
from ..ops.kernels.subm_conv import subm_conv
from ..ops.kernels.window_conv import (window_conv, window_conv_plain,
                                       window_conv_shifted,
                                       window_conv_shifted_plain)
from ..utils.device import resolve_device

M, C, D, K3 = 16384, 32, 32, 27
WARMUP, REPEATS = 3, 10
# kernels and plain versions are float32 sums in different orders
GEMM_TOL = 1e-4
D_PAIRS = ((27, 16), (9, 48), (27, 64), (9, 192), (27, 4), (9, 128))


def median_ms(fn, device: torch.device) -> float:
    """Median time of ``fn()`` in ms: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPEATS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    err = (got.double() - ref.double()).abs().max().item()
    return err / (ref.double().abs().max().item() + 1e-9)


def _tensor(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def gather_gemm_inputs(m, c, d, k3, device):
    """probe_a / probe_b / probe_c's inputs: table, indices, weights (drawn
    in that order, so probe_a's table and indices are the others')."""
    rng = np.random.default_rng(0)
    tab = _tensor(rng.normal(size=(m, c)).astype(np.float32), device)
    idx = _tensor(rng.integers(0, m, (m, k3)).astype(np.int32), device)
    w = _tensor(rng.normal(size=(k3, c, d)).astype(np.float32) * 0.1, device)
    return tab, idx, w


def gather_einsum(tab, idx, w):
    """probe_c's function: ``einsum("mkc,kcd->md", tab[idx], w)``."""
    return torch.einsum("mkc,kcd->md", tab[idx.long()], w)


def probe_c(device, m=M, c=C, d=D, k3=K3) -> dict:
    """Plain PyTorch reference: gather + einsum."""
    tab, idx, w = gather_gemm_inputs(m, c, d, k3, device)
    return {"ms": median_ms(lambda: gather_einsum(tab, idx, w), device)}


def probe_d(device, m=M, pairs=D_PAIRS) -> list:
    """Plain torch row gathers: rows per query against row width."""
    rng = np.random.default_rng(0)
    out = []
    for rows, width in pairs:
        tab = _tensor(rng.normal(size=(m, width)).astype(np.float32), device)
        idx = _tensor(rng.integers(0, m, (m, rows)).astype(np.int32),
                      device).long()
        out.append({"rows": rows, "width": width,
                    "mb": m * rows * width * 4 / 2 ** 20,
                    "ms": median_ms(lambda: tab[idx], device)})
    return out


def probe_a(device, m=M, c=C, k3=K3) -> dict:
    """The row-gather kernel at k3 rows per query."""
    tab, idx, _ = gather_gemm_inputs(m, c, D, k3, device)
    got = row_gather(tab, idx)
    if not torch.equal(got, row_gather_plain(tab, idx)):
        raise RuntimeError("A: row_gather differs from advanced indexing")
    return {"ms": median_ms(lambda: row_gather(tab, idx), device),
            "plain_ms": median_ms(lambda: row_gather_plain(tab, idx), device)}


def probe_b(device, m=M, c=C, d=D, k3=K3) -> dict:
    """Fused gather + tap GEMM: the index-map sparse conv kernel, B = 1."""
    if k3 != 27:
        raise ValueError("the index-map sparse conv has 27 taps")
    tab, idx, w = gather_gemm_inputs(m, c, d, k3, device)
    tab1, idx1 = tab[None], idx[None]
    err = rel_err(subm_conv(tab1, idx1, w)[0], gather_einsum(tab, idx, w))
    if err > GEMM_TOL:
        raise RuntimeError(f"B: subm_conv rel err {err} vs gather + einsum")
    return {"ms": median_ms(lambda: subm_conv(tab1, idx1, w), device),
            "rel_err": err}


def probe_w(device, m=16000, c=C, d=D) -> dict:
    """The x-window sparse conv kernel vs window_gather + einsum."""
    rng = np.random.default_rng(0)
    feats = _tensor(rng.normal(size=(m, c)).astype(np.float32), device)[None]
    pos = rng.integers(0, m, (m, 9)).astype(np.int32)
    sel = rng.integers(0, 3, (m, 9, 3))
    packed = pos | ((sel[..., 0] | (sel[..., 1] << 2)
                     | (sel[..., 2] << 4)) << 20)
    win = _tensor(packed.astype(np.int32), device)[None]
    w = _tensor(rng.normal(size=(27, c, d)).astype(np.float32) * 0.1, device)
    err = rel_err(window_conv(feats, win, w),
                  window_conv_plain(feats, win, w))
    if err > GEMM_TOL:
        raise RuntimeError(f"W: window_conv rel err {err}")
    return {"plain_ms": median_ms(lambda: window_conv_plain(feats, win, w),
                                  device),
            "ms": median_ms(lambda: window_conv(feats, win, w), device),
            "rel_err": err}


def e_shapes(m: int = M) -> tuple:
    """probe_e's four (rows, width) tables, scaled to ``m`` base rows."""
    return ((m, 32), (m, 48), (m, 128), (m * 5 // 2, 48))


def probe_e(device, shapes=None) -> list:
    """The row-gather kernel at one row per query."""
    rng = np.random.default_rng(0)
    out = []
    for m, width in shapes or e_shapes():
        tab_np = rng.normal(size=(m, width)).astype(np.float32)
        idx_np = rng.integers(0, m, (m, 1)).astype(np.int32)
        tab, idx = _tensor(tab_np, device), _tensor(idx_np, device)
        got = row_gather(tab, idx).cpu().numpy()
        err = float(np.abs(got - tab_np[idx_np[:, 0]]).max())
        if err != 0.0:
            raise RuntimeError(f"E: row_gather (M={m}, W={width}) max err "
                               f"{err}")
        out.append({"m": m, "width": width, "mb": m * width * 4 / 2 ** 20,
                    "ms": median_ms(lambda: row_gather(tab, idx), device),
                    "max_err": err})
    return out


def probe_f(device, m=M, c=C, d=D) -> dict:
    """The 9-slot x-window conv over a pre-shifted (m, 3c) table."""
    rng = np.random.default_rng(0)
    tab = _tensor(rng.normal(size=(m, 3 * c)).astype(np.float32), device)
    pos = _tensor(rng.integers(0, m, (m, 9)).astype(np.int32), device)
    sel = _tensor(rng.integers(0, 64, (m, 9)).astype(np.int32), device)
    w = _tensor(rng.normal(size=(27, c, d)).astype(np.float32) * 0.1, device)
    err = rel_err(window_conv_shifted(tab, pos, sel, w),
                  window_conv_shifted_plain(tab, pos, sel, w))
    if err > GEMM_TOL:
        raise RuntimeError(f"F: window_conv_shifted rel err {err}")
    return {"ms": median_ms(lambda: window_conv_shifted(tab, pos, sel, w),
                            device),
            "plain_ms": median_ms(
                lambda: window_conv_shifted_plain(tab, pos, sel, w), device),
            "rel_err": err}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="multimodal_gar_tpu_torch.tools.probe_gather")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rows", type=int, default=M,
                        help="table rows and queries of every probe")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    m = args.rows
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu, plain versions, host clock"
    print(f"probe_gather on {where}", flush=True)
    with torch.inference_mode():
        r = probe_c(device, m)
        print(f"C: torch gather+einsum (M={m}, K3={K3}, C={C}, D={D}): "
              f"{r['ms']:.3f} ms", flush=True)
        for r in probe_d(device, m):
            print(f"D: torch gather rows/query={r['rows']} "
                  f"width={r['width']} (bytes={r['mb']:.1f} MB): "
                  f"{r['ms']:.3f} ms", flush=True)
        r = probe_a(device, m)
        print(f"A: row_gather kernel (M={m}, K3={K3}, C={C}): "
              f"{r['ms']:.3f} ms, advanced indexing {r['plain_ms']:.3f} ms, "
              f"equal", flush=True)
        r = probe_b(device, m)
        print(f"B: fused gather+GEMM, subm_conv kernel (M={m}, K3={K3}, "
              f"C={C}, D={D}): {r['ms']:.3f} ms, rel max err "
              f"{r['rel_err']:.2e}", flush=True)
        mw = m if m != M else 16000
        r = probe_w(device, mw)
        print(f"W: torch window_gather+einsum (M={mw}, C={C}, D={D}): "
              f"{r['plain_ms']:.3f} ms", flush=True)
        print(f"W: window_conv kernel: {r['ms']:.3f} ms", flush=True)
        print(f"W: rel max err vs window_gather+einsum: {r['rel_err']:.2e}",
              flush=True)
        for r in probe_e(device, e_shapes(m)):
            print(f"E: row_gather kernel, 1 row/query (M={r['m']}, "
                  f"W={r['width']}, {r['mb']:.1f} MB): {r['ms']:.3f} ms  "
                  f"maxerr={r['max_err']:.1e}", flush=True)
        r = probe_f(device, m)
        print(f"F: window_conv_shifted kernel (M={m}, C={C}, D={D}): "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, rel max err "
              f"{r['rel_err']:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
