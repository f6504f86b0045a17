"""The port's losses, labels and ground-truth group helpers against the JAX
package's, on the same numpy outputs and labels.

Every loss term, L_eig included, agrees to 1e-6 relative (float32, sums in
other orders); the labels, the GT adjacency and the group counts are exact,
and so are the host eigenvector helpers (the same numpy code).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.ops import grouping as jgrouping
from multimodal_gar_tpu.train import labels as jlabels
from multimodal_gar_tpu.train import losses as jlosses
from multimodal_gar_tpu.types import ModelOutputs as JaxOutputs
from multimodal_gar_tpu_torch.ops import grouping
from multimodal_gar_tpu_torch.train import labels, losses
from multimodal_gar_tpu_torch.types import ModelOutputs
from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import assert_close, jax_batch

TOL = 1e-6
B, N = 2, 8
WIDTHS = (2, 4, 7, 5)


@pytest.fixture(scope="module")
def scene():
    """A tiny batch and random model outputs (probabilities in (0, 1),
    softmax rows for the pose heads), zero on padded actors."""
    fields = synthetic_batch_numpy(tiny_config(), batch_size=B, seed=3)
    rng = np.random.default_rng(4)
    vm = fields["person_valid"][..., None].astype(np.float32)

    def probs(width, softmax=False):
        x = rng.normal(size=(B, N, width)).astype(np.float32)
        p = (np.exp(x) / np.exp(x).sum(-1, keepdims=True) if softmax
             else 1 / (1 + np.exp(-x)))
        return (p * vm).astype(np.float32)

    pair = (fields["person_valid"][:, :, None]
            & fields["person_valid"][:, None, :])
    # a_theta below 0.3: the spectral term exp(-tr(Lbar^T L)) then stays
    # near 1; for a_theta up to 1 the trace is ~6, a difference of larger
    # float32 terms whose rounding exp turns into ~1e-3 relative on both
    # sides (against float64)
    outs = dict(
        a_theta=(rng.uniform(0, 0.3, size=(B, N, N)) * pair
                 ).astype(np.float32),
        pose=tuple(probs(4, True) for _ in range(3)),
        interaction=tuple(probs(w) for w in WIDTHS),
        sg_pose=tuple(probs(4) for _ in range(3)),
        sg_interaction=tuple(probs(w) for w in WIDTHS),
        card=rng.normal(2.0, 1.0, size=(B, 1)).astype(np.float32),
        group_ids=np.zeros((B, N), np.int32))
    e_hat, e_count = jlosses.prepare_eig_inputs(fields["social_group_id"],
                                                fields["person_valid"])
    return fields, outs, e_hat, e_count


def _outputs(cls, outs, conv):
    return cls(**{k: tuple(conv(x) for x in v) if isinstance(v, tuple)
                  else conv(v) for k, v in outs.items()})


def test_every_loss_term_matches_jax(scene):
    fields, outs, e_hat, e_count = scene
    ref = jlosses.compute_losses(_outputs(JaxOutputs, outs, jnp.asarray),
                                 jax_batch(fields), jnp.asarray(e_hat),
                                 jnp.asarray(e_count))
    got = losses.compute_losses(
        _outputs(ModelOutputs, outs, torch.from_numpy),
        batch_from_numpy(fields), torch.from_numpy(e_hat),
        torch.from_numpy(e_count))
    assert set(got) == set(ref) and "L_eig" in got
    assert float(ref["L_eig"]) != 0.0
    for name, v in ref.items():
        assert_close(got[name].item(), float(v), TOL, name)
    for name in ("L_total", "L_g", "L_act", "L_bce"):
        assert_close(losses.total_loss(got, name).item(),
                     float(jlosses.total_loss(ref, name)), TOL, name)


def test_eig_inputs_match_jax(scene):
    fields, _, e_hat, e_count = scene
    got = losses.prepare_eig_inputs(fields["social_group_id"],
                                    fields["person_valid"])
    np.testing.assert_array_equal(got[0], e_hat)
    np.testing.assert_array_equal(got[1], e_count)


def test_labels_and_group_helpers_match_jax_exactly(scene):
    fields, _, _, _ = scene
    valid = fields["person_valid"]
    for key in ("actions", "social_group_activity"):
        ref = jlabels.partition_action_labels(jnp.asarray(fields[key]),
                                              jnp.asarray(valid))
        got = labels.partition_action_labels(torch.from_numpy(fields[key]),
                                             torch.from_numpy(valid))
        assert len(got) == len(ref) == 7
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    sid = fields["social_group_id"]
    for b in range(B):
        np.testing.assert_array_equal(
            grouping.gt_adjacency(torch.from_numpy(sid),
                                  torch.from_numpy(valid))[b].numpy(),
            np.asarray(jgrouping.gt_adjacency(jnp.asarray(sid[b]),
                                              jnp.asarray(valid[b]))))
        assert grouping.num_groups(torch.from_numpy(sid),
                                   torch.from_numpy(valid))[b].item() \
            == float(jgrouping.num_groups(jnp.asarray(sid[b]),
                                          jnp.asarray(valid[b])))
