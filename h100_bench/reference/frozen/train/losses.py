"""Loss functions (train/losses.py:34-227): grouping (BCE, weighted BCE,
spectral), cardinality, action and activity, batched and masked.

The spectral loss's zero-eigenvectors are ground-truth quantities computed
on the host with numpy (``zero_eigvecs_host``, ``prepare_eig_inputs``);
they are carried here because the JAX module that holds them imports jax.

The two losses whose count spans the whole batch, ``masked_bce_mean`` and
``ce_on_probs``, divide by ``denominator(count)``: the count, at least 1,
by default; a step on a mesh passes the global count's share
(parallel/mesh.py: ``batch_denominator``). The others are per-scene means
averaged over the batch, which the mean over equal local batches
reproduces as it is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.grouping import gt_adjacency, num_groups
from ..types import Batch, ModelOutputs
from .labels import partition_action_labels
from .loss_lib import local_count

EPS = 1e-7


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on probabilities clipped to
    [EPS, 1 - EPS]."""
    p = torch.clamp(pred, EPS, 1.0 - EPS)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def masked_bce_mean(pred: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor, denominator=local_count
                    ) -> torch.Tensor:
    """Mean BCE over the masked elements of ``pred``; the mask is broadcast
    to pred's full shape before counting, so a (B, N, 1) row mask against
    (B, N, C) predictions divides by rows * C."""
    m = torch.broadcast_to(mask, pred.shape).to(pred.dtype)
    return torch.sum(_bce(pred, target) * m) / denominator(torch.sum(m))


def _pair(valid: torch.Tensor, dtype) -> torch.Tensor:
    return (valid[:, None, :] & valid[:, :, None]).to(dtype)


def adjacency_bce(a_theta: torch.Tensor, a_hat: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Per-scene mean BCE over the valid N x N block, then the batch
    mean."""
    pair = _pair(valid, a_theta.dtype)
    per_scene = torch.sum(_bce(a_theta, a_hat) * pair, dim=(1, 2)) \
        / torch.clamp(torch.sum(pair, dim=(1, 2)), min=1.0)
    return torch.mean(per_scene)


def adjacency_bce_weighted(a_theta: torch.Tensor, a_hat: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Class-ratio-weighted BCE over the off-diagonal valid pairs: positive
    pairs weighted by #neg / (3 #pos + 1). The ratio and the denominator are
    per scene, so the batch mean needs no global count."""
    n = a_theta.shape[-1]
    eye = torch.eye(n, dtype=a_theta.dtype, device=a_theta.device)
    off_diag = _pair(valid, a_theta.dtype) * (1.0 - eye)[None]
    pos = a_hat * off_diag
    neg = (1.0 - a_hat) * off_diag
    num_pos = torch.sum(pos, dim=(1, 2))
    num_total = torch.sum(off_diag, dim=(1, 2))
    ratio = (num_total - num_pos) / (3.0 * num_pos + 1.0)        # (B,)
    bce = _bce(a_theta, a_hat) * off_diag
    weighted = ratio[:, None, None] * bce * pos + bce * neg
    per_scene = torch.sum(weighted, dim=(1, 2)) \
        / torch.clamp(num_total, min=1.0)
    return torch.mean(per_scene)


def ce_on_probs(pred_probs: torch.Tensor, target: torch.Tensor,
                valid: torch.Tensor, denominator=local_count
                ) -> torch.Tensor:
    """The reference's CrossEntropyLoss on already-softmaxed head outputs
    with multi-hot targets (a quirk kept for parity): the masked row mean
    of -sum_c t_c * log_softmax(p)_c."""
    logp = torch.log_softmax(pred_probs, dim=-1)
    per_row = -torch.sum(target * logp, dim=-1)                 # (B, N)
    m = valid.to(per_row.dtype)
    return torch.sum(per_row * m) / denominator(torch.sum(m))


def zero_eigvecs_host(a_hat: np.ndarray, n_valid: int, max_vecs: int
                      ) -> Tuple[np.ndarray, int]:
    """HOST: the zero-eigenvalue eigenvectors of L_hat^T L_hat (columns of
    eigh, |eigenvalue| < 1e-9) as (max_vecs, N) padded rows, and their
    count."""
    n = a_hat.shape[0]
    sub = a_hat[:n_valid, :n_valid].astype(np.float64)
    lap = np.diag(sub.sum(axis=1)) - sub
    evals, evecs = np.linalg.eigh(lap.T @ lap)
    vecs = evecs[:, np.abs(evals) < 1e-9].T                     # (k, n_valid)
    k = min(vecs.shape[0], max_vecs)
    out = np.zeros((max_vecs, n), np.float32)
    out[:k, :n_valid] = vecs[:k]
    return out, k


def prepare_eig_inputs(social_group_id: np.ndarray, valid: np.ndarray,
                       max_vecs: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """HOST: batched zero-eigenvector prep of the spectral loss ->
    (e_hat (B, max_vecs, N) float32, e_count (B,) int32)."""
    b, n = social_group_id.shape
    e_hat = np.zeros((b, max_vecs, n), np.float32)
    e_count = np.zeros((b,), np.int32)
    for i in range(b):
        nv = int(valid[i].sum())
        if nv == 0:
            continue
        sid = social_group_id[i][:nv]
        a = (sid[:, None] == sid[None, :]) | np.eye(nv, dtype=bool)
        full = np.zeros((n, n), np.float32)
        full[:nv, :nv] = a
        e_hat[i], e_count[i] = zero_eigvecs_host(full, nv, max_vecs)
    return e_hat, e_count


def eig_loss(a_theta: torch.Tensor, e_hat: torch.Tensor,
             e_count: torch.Tensor, valid: torch.Tensor, alpha: float = 1.0,
             beta: float = 1.0) -> torch.Tensor:
    """Device part of the spectral loss: the full sum of e L^T L e^T over
    the GT zero-eigenvectors e, plus alpha * exp(-beta * tr(Lbar^T L))
    with Lbar = L (I - e^T e); 0 for a scene without eigenvectors."""
    n = a_theta.shape[-1]
    a = a_theta * _pair(valid, a_theta.dtype)
    lap = torch.diag_embed(torch.sum(a, dim=2)) - a             # (B, N, N)
    kmask = (torch.arange(e_hat.shape[1], device=e_hat.device)[None]
             < e_count[:, None]).to(a.dtype)
    e = e_hat * kmask[..., None]                                # (B, K, N)
    lt_l = lap.transpose(1, 2) @ lap
    first = torch.sum((e @ lt_l) @ e.transpose(1, 2), dim=(1, 2))
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    lbar = lap @ (eye - e.transpose(1, 2) @ e)
    trace = torch.diagonal(lbar.transpose(1, 2) @ lap, dim1=1,
                           dim2=2).sum(-1)
    second = alpha * torch.exp(-beta * trace)
    has_vecs = (e_count > 0).to(a.dtype)
    return torch.mean((first + second) * has_vecs)


def compute_losses(outputs: ModelOutputs, batch: Batch,
                   e_hat: Optional[torch.Tensor] = None,
                   e_count: Optional[torch.Tensor] = None,
                   denominator=local_count) -> Dict[str, torch.Tensor]:
    """All loss terms (train_func.py:172-256); ``denominator`` turns the
    count of a loss that spans the batch into its divisor."""
    valid = batch.person_valid
    a_hat = gt_adjacency(batch.social_group_id, valid)
    l_bce = adjacency_bce(outputs.a_theta, a_hat, valid)
    l_bce2 = adjacency_bce_weighted(outputs.a_theta, a_hat, valid)
    n_groups = num_groups(batch.social_group_id, valid)
    l_mse = torch.mean((outputs.card[:, 0] - n_groups) ** 2)

    labels = partition_action_labels(batch.actions, valid)
    sg_labels = partition_action_labels(batch.social_group_activity, valid)
    rows = valid[..., None]
    kw = dict(denominator=denominator)
    l_pose = sum(ce_on_probs(outputs.pose[i], labels[i], valid, **kw)
                 for i in range(3))
    l_inter = sum(masked_bce_mean(outputs.interaction[i], labels[3 + i], rows,
                                  **kw) for i in range(4))
    sg_l_pose = sum(masked_bce_mean(outputs.sg_pose[i], sg_labels[i], rows,
                                    **kw) for i in range(3))
    sg_l_inter = sum(masked_bce_mean(outputs.sg_interaction[i],
                                     sg_labels[3 + i], rows, **kw)
                     for i in range(4))
    losses = {
        "L_bce": l_bce, "L_bce2": l_bce2, "L_mse": l_mse,
        "L_pose": l_pose, "L_interaction": l_inter,
        "L_act": l_pose + l_inter, "SG_L_pose": sg_l_pose,
        "SG_L_interaction": sg_l_inter, "SG_L_act": sg_l_pose + sg_l_inter,
    }
    if e_hat is not None:
        losses["L_eig"] = eig_loss(outputs.a_theta, e_hat, e_count, valid)
        losses["L_g"] = l_bce + losses["L_eig"] + l_mse
    return losses


def total_loss(losses: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """Loss selection (train_func.py:245-256)."""
    if name == "L_total":
        return losses["L_bce"] + losses["L_act"] + losses["SG_L_act"]
    if name == "L_g":
        return losses["L_g"]
    if name == "L_act":
        return losses["L_act"] + losses["SG_L_act"]
    return losses[name]
