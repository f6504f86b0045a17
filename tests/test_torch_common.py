"""Shared helpers of the port's parity tests, and tests of the helpers.

The parity tests feed the same numpy-seeded inputs and weights to a JAX
function and its counterpart in multimodal_gar_tpu_torch. Weights come from
the JAX module's own init shapes, are drawn anew with numpy (every BatchNorm
statistic included, variances > 0, so that no zero-initialised scale leaves
a block an identity), and reach the port through its converter.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from multimodal_gar_tpu.config import Config
from multimodal_gar_tpu.types import Batch as JaxBatch
from multimodal_gar_tpu_torch.convert import load_jax_variables

# The tier-1 run puts six pytest workers on eight cores. At torch's default
# of one intra-op thread per core their threads outnumber the cores six
# times over and the port's many small ops pay in thread wake-ups; every
# worker imports this module when it collects the port's tests.
torch.set_num_threads(2)


def random_variables(module, *args, seed: int = 0, **kwargs) -> dict:
    """Variables of a flax ``module`` for ``module.init(key, *args,
    **kwargs)``, every leaf drawn with numpy: kernels N(0, 1 / fan_in),
    scales and variances U(0.5, 1.5), biases and means N(0, 0.1)."""
    shapes = jax.eval_shape(partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for path, s in sorted(flatten_dict(tree).items()):
            name = path[-1]
            if name in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, s.shape)
            elif name in ("bias", "mean"):
                v = rng.normal(0.0, 0.1, s.shape)
            else:                          # kernels and raw (in, out) weights
                fan_in = int(np.prod(s.shape[:-1]))
                v = rng.normal(0.0, fan_in ** -0.5, s.shape)
            flat[path] = np.asarray(v, np.float32)
        out[col] = unflatten_dict(flat)
    return out


def to_jax(variables: dict):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def port_module(cls, *args, variables: dict, **kwargs):
    """A port module on the CPU with the given flax variables loaded."""
    mod = cls(*args, device="cpu", generator=torch.Generator().manual_seed(0),
              **kwargs)
    load_jax_variables(mod, variables)
    return mod.eval()


def assert_close(got, ref, tol: float, what: str = "") -> float:
    """max |got - ref| <= tol * max |ref|; returns the relative error."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    scale = max(float(np.max(np.abs(ref), initial=0.0)), 1e-30)
    rel = float(np.max(np.abs(got - ref), initial=0.0)) / scale
    assert rel <= tol, f"{what}: rel err {rel:.3g} > {tol:g}"
    return rel


def exact_pool_config(cfg: Config) -> Config:
    """cfg with the JAX grid pool's neighbour selection set to exact top-k,
    the port's selection."""
    lidar = dataclasses.replace(cfg.model.lidar, pool_approx_nsample=False)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lidar=lidar))


def jax_batch(fields: dict) -> JaxBatch:
    """The JAX package's Batch from the port's numpy batch fields."""
    conv = {k: (jax.tree_util.tree_map(jnp.asarray, v) if isinstance(v, dict)
                else jnp.asarray(v)) for k, v in fields.items()}
    return JaxBatch(**conv)


def test_random_variables_cover_every_statistic():
    """Scales and variances > 0; zero-initialised flax leaves (the NL
    block's W_z_bn scale, biases) are drawn away from zero."""
    from multimodal_gar_tpu.models.nonlocal_block import NLBlockND
    x = jnp.zeros((2, 3, 3, 16), jnp.float32)
    v = random_variables(NLBlockND(16, 2, "dot"), x, train=False, seed=3)
    flat = flatten_dict(v["params"])
    assert np.all(flat[("W_z_bn", "scale")] >= 0.5)
    assert np.any(flat[("W_z", "bias")] != 0)
    assert np.all(flatten_dict(v["batch_stats"])[("W_z_bn", "var")] > 0)


def test_assert_close_is_relative_to_the_reference_scale():
    ref = np.array([100.0, -50.0])
    assert assert_close(ref + 1e-3, ref, 1e-4) <= 1e-4
    try:
        assert_close(ref + 1.0, ref, 1e-4)
    except AssertionError:
        return
    raise AssertionError("a 1e-2 relative error passed a 1e-4 tolerance")
