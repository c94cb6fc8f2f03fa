"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""

from unittest import mock

import jax
import numpy as np

from nerfies_tpu.models import nerf as jax_nerf


def jax_model_and_shapes(config, **construct_kwargs):
  """The Flax NerfModel of `construct_nerf` and its param shapes.

  Traces construct_nerf abstractly instead of running the Flax init, which
  takes tens of seconds at full width on the CPU. Its final device_get is
  bypassed so the traced params can leave the trace as shapes.
  """
  holder = {}

  def build(key):
    model, params = jax_nerf.construct_nerf(key, config, batch_size=16,
                                            **construct_kwargs)
    holder['model'] = model
    return params

  with mock.patch.object(jax, 'device_get', lambda tree: tree):
    shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
  return holder['model'], shapes


def random_params(shapes, seed=0):
  """A param tree of the given shapes, drawn from numpy with a seed.

  Kernels are Glorot-uniform, biases and embeddings uniform in
  (-0.1, 0.1) and (0, 0.5): larger than a fresh init's, so that a wrong
  route or a dropped term shows in the outputs.
  """
  rng = np.random.RandomState(seed)

  def draw(path, leaf):
    name = jax.tree_util.keystr(path)
    if name.endswith("['kernel']"):
      limit = np.sqrt(6.0 / (leaf.shape[0] + leaf.shape[1]))
      value = rng.uniform(-limit, limit, leaf.shape)
    elif name.endswith("['embedding']"):
      value = rng.uniform(0.0, 0.5, leaf.shape)
    else:
      value = rng.uniform(-0.1, 0.1, leaf.shape)
    return value.astype(np.float32)

  return jax.tree_util.tree_map_with_path(draw, shapes)
