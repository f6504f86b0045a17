"""The port's evaluator against the JAX package's on the same seeded model
outputs and batches: the metrics agree to 1e-6 (both score with copies of
the same numpy code; the per-person group confidence is one float32 sum)
and the six result files are byte-equal."""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_gar_tpu.eval import evaluator as jax_evaluator
from multimodal_gar_tpu.types import ModelOutputs as JaxOutputs
from multimodal_gar_tpu_torch.eval import evaluator
from multimodal_gar_tpu_torch.eval.jrdb_eval import ResultAccumulator
from multimodal_gar_tpu_torch.types import ModelOutputs
from multimodal_gar_tpu_torch.utils.testing import (batch_from_numpy,
                                                    synthetic_batch_numpy,
                                                    tiny_config)
from tests.test_torch_common import jax_batch

METRIC_TOL = 1e-6
FILES = ("action.txt", "activity.txt", "grouping.txt", "gt_action.txt",
         "gt_activity.txt", "gt_grouping.txt")
_WIDTHS = (2, 4, 7, 5)


def _outputs(rng, b, n, valid):
    """Seeded head outputs as numpy: softmax-like poses, sigmoid-like
    scores, a symmetric adjacency and group ids; padded rows zero."""
    def head(width):
        return (rng.uniform(size=(b, n, width)) * valid[..., None]
                ).astype(np.float32)
    a = rng.uniform(size=(b, n, n)).astype(np.float32)
    a = (a + a.transpose(0, 2, 1)) / 2 * (valid[:, :, None]
                                          & valid[:, None, :])
    gids = rng.integers(0, 3, (b, n)).astype(np.int32)
    gids[~valid] = -1
    return dict(
        a_theta=a.astype(np.float32), pose=tuple(head(4) for _ in range(3)),
        interaction=tuple(head(w) for w in _WIDTHS),
        sg_pose=tuple(head(4) for _ in range(3)),
        sg_interaction=tuple(head(w) for w in _WIDTHS),
        card=rng.uniform(size=(b, 1)).astype(np.float32), group_ids=gids)


@pytest.fixture(scope="module")
def stream():
    """Three batches of two frames and their outputs, as numpy."""
    cfg = tiny_config()
    rng = np.random.default_rng(0)
    items = []
    for i in range(3):
        fields = synthetic_batch_numpy(cfg, batch_size=2, seed=i)
        fields["frame_id"] = np.array([2 * i, 2 * i + 1], np.int32)
        fields["seq_id"] = np.array([i % 2, i % 2], np.int32)
        items.append((fields, _outputs(rng, 2, cfg.data.num_boxes,
                                       fields["person_valid"])))
    return items


def _tree(fn, value):
    if isinstance(value, tuple):
        return tuple(fn(v) for v in value)
    return fn(value)


def _run_both(stream, tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_outs = iter([JaxOutputs(**{k: _tree(jnp.asarray, v)
                                   for k, v in o.items()})
                     for _, o in stream])
    port_outs = iter([ModelOutputs(**{k: _tree(torch.from_numpy, v)
                                      for k, v in o.items()})
                      for _, o in stream])
    ref = jax_evaluator.evaluate_epoch(
        lambda b: next(jax_outs), [jax_batch(f) for f, _ in stream],
        result_dir=jax_dir)
    got = evaluator.evaluate_epoch(
        lambda b: next(port_outs), [batch_from_numpy(f) for f, _ in stream],
        result_dir=port_dir)
    return ref, got, jax_dir, port_dir


def test_evaluate_epoch_metrics_match(stream, tmp_path):
    ref, got, _, _ = _run_both(stream, tmp_path)
    assert list(got) == list(ref)
    for key in ("overall_AP", "action_AP", "activity_AP"):
        assert key in got
    for key, v in ref.items():
        assert abs(got[key] - v) <= METRIC_TOL, (key, got[key], v)
    assert any(v > 0 for v in ref.values())


@pytest.mark.parametrize("name", FILES)
def test_result_files_are_byte_equal(stream, tmp_path, name):
    _, _, jax_dir, port_dir = _run_both(stream, tmp_path)
    assert os.path.getsize(os.path.join(port_dir, name)) > 0
    assert filecmp.cmp(os.path.join(jax_dir, name),
                       os.path.join(port_dir, name), shallow=False)


def test_scores_to_27_matches(stream):
    out = stream[0][1]
    pose = [p[0] for p in out["pose"]]
    inter = [p[0] for p in out["interaction"]]
    ref = jax_evaluator.scores_to_27(pose, inter)
    got = evaluator.scores_to_27(pose, inter)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (pose[0].shape[0], 27)
    assert not got[:, [10, 25, 26]].any()       # classes no head covers


def test_accumulate_batch_reads_tensors_on_any_device(stream):
    """Outputs and batch come to the host once per batch; requires_grad
    outputs (a training-mode forward) are accepted."""
    fields, out = stream[0]
    outputs = ModelOutputs(**{k: _tree(torch.from_numpy, v)
                              for k, v in out.items()})
    outputs.a_theta.requires_grad_()
    acc = ResultAccumulator()
    evaluator.accumulate_batch(acc, batch_from_numpy(fields), outputs)
    assert len(acc.det_groups) > 0
    assert evaluator.host_arrays((torch.ones(2),))[0].tolist() == [1.0, 1.0]
