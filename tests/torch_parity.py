"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""

from unittest import mock

import flax.linen as jnn
import jax
import numpy as np
import torch

from nerfies_tpu import configs as jax_configs
from nerfies_tpu.models import nerf as jax_nerf
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp


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


def grad_check(got, want, tag, cos_floor=0.95, ratio=(0.7, 1.4)):
  """Per-leaf cosine > cos_floor and norm ratio in `ratio`.

  got: a nested dict of tensors; want: the JAX tree of the same names.
  Leaves negligible on both sides (below 1e-4 of the largest norm) are
  skipped, since bf16 noise sets their direction (tests/
  test_fused_train.py:166-182).
  """
  got = dict(fused_mlp.flatten_tree(got))
  want = {tuple(k.key for k in path): np.asarray(v, np.float64).ravel()
          for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
  assert set(got) == set(want), tag
  ref = max(np.linalg.norm(v) for v in want.values())
  for path, b in want.items():
    a = got[path].detach().double().numpy().ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if max(na, nb) < 1e-4 * ref:
      continue
    cos = float(a @ b / (na * nb))
    assert cos > cos_floor, f'{tag} {path}: cosine {cos}'
    assert ratio[0] < (na + 1e-12) / (nb + 1e-12) < ratio[1], \
        f'{tag} {path}: {na}/{nb}'


def port_model(field='se3', warp_kwargs=None):
  """The port's NerfModel with the architecture of tests/test_fused_train.py
  _build (its params are not used: the tests load JAX's)."""
  config = configs.ModelConfig(
      num_coarse_samples=6, num_fine_samples=6, nerf_trunk_depth=3,
      nerf_trunk_width=32, nerf_rgb_branch_depth=1, nerf_rgb_branch_width=16,
      nerf_skips=(2,), num_nerf_point_freqs=3, num_nerf_viewdir_freqs=2,
      num_warp_freqs=2, use_warp=True, warp_field_type=field,
      warp_kwargs=warp_kwargs or {'trunk_depth': 3, 'skips': (2,)},
      use_appearance_metadata=True, use_alpha_condition=True,
      use_rgb_condition=True, sigma_activation='softplus',
      use_stratified_sampling=False, noise_std=None, use_bfloat16=True,
      use_fused_mlp=True)
  model, _ = nerf.construct_nerf(
      config, appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
      near=0.5, far=3.0, device='cpu', use_warp_jacobian=True,
      use_weights=True)
  return model


# A small model of every architecture switch, in both packages' configs.
SMALL_MODEL = dict(
    num_coarse_samples=6, num_fine_samples=5, nerf_trunk_depth=3,
    nerf_trunk_width=32, nerf_rgb_branch_depth=1, nerf_rgb_branch_width=16,
    nerf_skips=(2,), num_nerf_point_freqs=3, num_nerf_viewdir_freqs=2,
    num_warp_freqs=2, num_warp_features=4, use_warp=True,
    warp_field_type='se3',
    warp_kwargs={'trunk_depth': 3, 'trunk_width': 32, 'skips': (2,)},
    use_stratified_sampling=False, noise_std=None, use_bfloat16=False,
    use_fused_mlp=False)
SMALL_IDS = dict(appearance_ids=(0, 1, 2), camera_ids=(0, 1),
                 warp_ids=(0, 1, 2), near=0.5, far=3.0)


def jax_config(**fields):
  """nerfies_tpu.configs.ModelConfig of the port's fields: activations
  by name become the flax.linen functions."""
  for key in ('activation', 'sigma_activation'):
    if isinstance(fields.get(key), str):
      fields[key] = getattr(jnn, fields[key])
  return jax_configs.ModelConfig(**fields)


def model_pair(seed=0, use_warp_jacobian=True, use_weights=True,
               **overrides):
  """The Flax model and random params, and the port's model over the same
  params: (jax_model, jax_params, model, params). The port's tree builders
  must give JAX's names and shapes."""
  fields = {**SMALL_MODEL, **overrides}
  kwargs = dict(SMALL_IDS, use_warp_jacobian=use_warp_jacobian,
                use_weights=use_weights)
  jmodel, shapes = jax_model_and_shapes(jax_config(**fields), **kwargs)
  jparams = random_params(shapes, seed)
  model, own = nerf.construct_nerf(configs.ModelConfig(**fields),
                                   device='cpu', **kwargs)
  flat_shapes = {tuple(k.key for k in path): tuple(v.shape) for path, v in
                 jax.tree_util.tree_flatten_with_path(shapes)[0]}
  assert {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(own)} == \
      flat_shapes
  return jmodel, jparams, model, interop.params_from_jax(jparams, 'cpu')


def ray_batch(num_rays=8, seed=0):
  """Rays from random origins with ids of SMALL_IDS and times in [0, 1)."""
  rng = np.random.RandomState(seed)
  directions = rng.normal(size=(num_rays, 3)).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  ids = lambda high: rng.randint(0, high, (num_rays, 1)).astype(np.uint32)
  return {
      'origins': (0.1 * rng.normal(size=(num_rays, 3))).astype(np.float32),
      'directions': directions,
      'metadata': {'warp': ids(3), 'appearance': ids(3), 'camera': ids(2),
                   'time': rng.uniform(size=(num_rays, 1)).astype(
                       np.float32)},
  }


def to_torch(tree):
  """Nested numpy arrays -> tensors (integers as int64)."""
  if isinstance(tree, dict):
    return {k: to_torch(v) for k, v in tree.items()}
  array = np.asarray(tree)
  if np.issubdtype(array.dtype, np.integer):
    array = array.astype(np.int64)
  return torch.from_numpy(array.copy())
