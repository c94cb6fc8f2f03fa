"""The port's param trees have the JAX package's names, shapes and layout."""

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch
import torch_parity

from nerfies_tpu import configs as jax_configs
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.models import nerf


def _shapes(tree):
  return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
          for k, v in tree.items()}


def _jax_shapes(tree):
  return _shapes(jax.tree.map(lambda s: s, dict(tree)))


@pytest.fixture(scope='module')
def bench_config():
  """bench.py's render model config (bench.py:57-87, 268-272).

  Importing bench.py points JAX's compile cache at its own directory, so
  the test process's settings are put back right after.
  """
  saved = {name: getattr(jax.config, name) for name in (
      'jax_compilation_cache_dir',
      'jax_persistent_cache_min_compile_time_secs')}
  import bench  # pylint: disable=import-outside-toplevel
  for name, value in saved.items():
    jax.config.update(name, value)
  return bench.model_config(use_stratified_sampling=False)


def test_bench_render_config_matches_bench(bench_config):
  jax_config = bench_config
  config = configs.bench_render_config()
  for field in ('num_coarse_samples', 'num_fine_samples', 'nerf_trunk_depth',
                'nerf_trunk_width', 'nerf_rgb_branch_depth',
                'nerf_rgb_branch_width', 'num_nerf_point_freqs',
                'num_nerf_viewdir_freqs', 'use_warp', 'warp_field_type',
                'num_warp_freqs', 'num_warp_features',
                'use_appearance_metadata', 'use_camera_metadata',
                'camera_metadata_dims', 'use_stratified_sampling',
                'use_sample_at_infinity', 'nerf_skips',
                'use_viewdirs', 'use_alpha_condition', 'use_rgb_condition'):
    assert getattr(config, field) == getattr(jax_config, field), field
  assert jax_config.sigma_activation is nn.softplus
  # The port serves in bf16 with ReLU, as the JAX fused path does.
  assert jax_config.use_bfloat16 and jax_config.activation is nn.relu
  assert config.sigma_activation == 'softplus'


_SMALL = dict(nerf_trunk_depth=3, nerf_trunk_width=32, nerf_rgb_branch_width=16,
              nerf_skips=(2,), num_nerf_point_freqs=3, num_warp_freqs=2,
              num_coarse_samples=4, num_fine_samples=4, use_warp=True,
              use_appearance_metadata=True, use_alpha_condition=True,
              use_rgb_condition=True, use_camera_metadata=True)


@pytest.mark.parametrize('name,kwargs', [
    ('bench', None),
    ('small_se3', dict(_SMALL, warp_field_type='se3',
                       warp_kwargs={'trunk_depth': 3, 'skips': (2,)})),
    ('small_se3_split_heads', dict(
        _SMALL, warp_field_type='se3',
        warp_kwargs={'trunk_depth': 3, 'skips': (2,),
                     'fuse_branch_heads': False})),
    ('small_translation', dict(
        _SMALL, warp_field_type='translation',
        warp_kwargs={'depth': 3, 'skips': (2,), 'hidden_channels': 16})),
    ('no_warp_no_fine', dict(_SMALL, use_warp=False, num_fine_samples=0,
                             use_trunk_condition=True)),
])
def test_construct_nerf_tree_matches_jax(name, kwargs, bench_config):
  if kwargs is None:
    config = configs.bench_render_config()
    jax_config = bench_config
    ids = configs.BENCH_RENDER_IDS
  else:
    config = configs.ModelConfig(**kwargs)
    jax_config = jax_configs.ModelConfig(**kwargs)
    ids = dict(appearance_ids=(0, 1, 2), camera_ids=(0,), warp_ids=(0, 1),
               near=0.5, far=3.0)
  _, want = torch_parity.jax_model_and_shapes(jax_config, **ids)
  model, params = nerf.construct_nerf(
      config, **ids, generator=torch.Generator().manual_seed(0),
      device='cpu')
  assert _shapes(params) == _jax_shapes(want), name
  assert _shapes(model.params) == _shapes(params)
  assert all(p.dtype == torch.float32 for p in model.parameters())


def test_construct_nerf_is_seeded():
  config = configs.ModelConfig(**dict(_SMALL, warp_field_type='se3'))
  ids = dict(appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
             near=0.5, far=3.0)
  trees = [nerf.construct_nerf(config, **ids, device='cpu',
                               generator=torch.Generator().manual_seed(s))[1]
           for s in (7, 7, 8)]
  k = lambda t: t['nerf_mlps_coarse']['trunk_hidden_1']['kernel']
  assert torch.equal(k(trees[0]), k(trees[1]))
  assert not torch.equal(k(trees[0]), k(trees[2]))


def test_params_from_jax_keeps_the_layout():
  config = jax_configs.ModelConfig(**dict(_SMALL, warp_field_type='se3'))
  ids = dict(appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
             near=0.5, far=3.0)
  _, shapes = torch_parity.jax_model_and_shapes(config, **ids)
  jax_params = torch_parity.random_params(shapes, seed=3)
  params = interop.params_from_jax(jax_params, device='cpu')
  assert _shapes(params) == _jax_shapes(shapes)
  # Flax Dense kernels are (in, out); the port keeps them so: x @ kernel.
  k = jax_params['nerf_mlps_coarse']['trunk_hidden_0']['kernel']
  got = params['nerf_mlps_coarse']['trunk_hidden_0']['kernel']
  assert tuple(got.shape) == k.shape == (21, 32)
  np.testing.assert_array_equal(got.numpy(), k)
  x = np.random.RandomState(0).normal(size=(4, 21)).astype(np.float32)
  np.testing.assert_allclose((torch.from_numpy(x) @ got).numpy(), x @ k,
                             rtol=1e-5, atol=1e-5)
