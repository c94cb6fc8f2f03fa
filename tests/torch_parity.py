"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""

from unittest import mock

import jax
import numpy as np

from nerfies_tpu.models import nerf as jax_nerf
from nerfies_tpu_torch import configs
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


def grad_check(got, want, tag, cos_floor=0.95):
  """Per-leaf cosine > cos_floor and norm ratio in (0.7, 1.4).

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
    assert 0.7 < (na + 1e-12) / (nb + 1e-12) < 1.4, f'{tag} {path}: {na}/{nb}'


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
      use_stratified_sampling=False, noise_std=None)
  model, _ = nerf.construct_nerf(
      config, appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
      near=0.5, far=3.0, device='cpu', use_warp_jacobian=True,
      use_weights=True)
  return model
