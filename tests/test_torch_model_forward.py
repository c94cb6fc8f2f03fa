"""NerfModel.forward against the Flax NerfModel's `model.apply`, on the CPU.

The same random params (tests/torch_parity.random_params, loaded by name
through interop.params_from_jax) and the same rays go through JAX's
`model.apply` and the port's plain forward, deterministic sampling,
noise_std None, small widths (tests/torch_parity.SMALL_MODEL). Compared
key by key at each level: float32 at atol 1e-5, rtol 1e-4; Jacobians at
atol 1e-4 (tests/test_models.py:123); bf16 at atol = rtol = 0.05
(tests/test_fused_mlp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp
from tests.torch_parity import SMALL_IDS
from tests.torch_parity import SMALL_MODEL
from tests.torch_parity import model_pair
from tests.torch_parity import ray_batch
from tests.torch_parity import to_torch

_EXTRA = {'alpha': 1.5, 'time_alpha': 0.3}
_SE3 = SMALL_MODEL['warp_kwargs']

# Architectures, as overrides of SMALL_MODEL.
_CASES = {
    # configs/gpu_vrig_paper.gin, narrowed: SE(3) warp, camera codes.
    'gpu_vrig_paper': dict(use_camera_metadata=True, camera_metadata_dims=2),
    # configs/test_local.gin, narrowed: appearance codes, 3 warp features.
    'test_local': dict(use_appearance_metadata=True, num_warp_features=3,
                       num_warp_freqs=3, sigma_activation='softplus'),
    'trunk_condition': dict(use_appearance_metadata=True,
                            use_trunk_condition=True,
                            use_alpha_condition=True, use_rgb_condition=True,
                            use_camera_metadata=True),
    'bf16': dict(use_bfloat16=True, use_camera_metadata=True,
                 use_appearance_metadata=True, use_alpha_condition=True,
                 use_rgb_condition=True),
    'time_encoder': dict(warp_metadata_encoder_type='time'),
    # A JAX tree of blend codes, pivot and translation branches and a trunk
    # condition loads by name and runs.
    'blend_pivot_translation_trunk': dict(
        warp_metadata_encoder_type='blend', use_appearance_metadata=True,
        use_trunk_condition=True,
        warp_kwargs={**_SE3, 'use_pivot': True, 'use_translation': True,
                     'pivot_width': 16, 'translation_depth': 1,
                     'translation_width': 16}),
    'translation_field': dict(
        warp_field_type='translation',
        warp_kwargs={'depth': 3, 'hidden_channels': 32, 'skips': (2,)}),
    'elu_no_viewdirs': dict(activation='elu', use_viewdirs=False,
                            use_white_background=True, rgb_padding=0.001,
                            use_linear_disparity=True),
    'no_warp': dict(use_warp=False, use_appearance_metadata=True,
                    use_rgb_condition=True),
}


def _tolerance(case, key):
  if case == 'bf16':
    return dict(atol=0.05, rtol=0.05)
  if key == 'warp_jacobian':
    return dict(atol=1e-4, rtol=1e-4)
  return dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('case', sorted(_CASES))
def test_forward_matches_model_apply(case):
  jmodel, jparams, model, params = model_pair(**_CASES[case])
  rays = ray_batch()
  want = jmodel.apply({'params': jparams}, jax.tree.map(jnp.asarray, rays),
                      warp_extra=_EXTRA, return_points=True,
                      return_weights=True)
  got = model(params, to_torch(rays), _EXTRA, return_points=True,
              return_weights=True)
  assert set(got) == set(want)
  for level in want:
    assert set(got[level]) == set(want[level]), level
    for key, value in want[level].items():
      np.testing.assert_allclose(
          got[level][key].detach().float().numpy(),
          np.asarray(value, np.float32), err_msg=f'{case} {level}/{key}',
          **_tolerance(case, key))
  if model.use_warp:
    assert got['coarse']['warp_jacobian'].shape == (3, 3, 8, 6)


def test_forward_output_switches_match_model_apply():
  """Without return_* the coarse weights go, and return_warp_jacobian
  adds the fine level's Jacobians, as in JAX."""
  jmodel, jparams, model, params = model_pair(use_warp_jacobian=False,
                                              use_weights=False)
  rays = ray_batch(seed=1)
  for kwargs in (dict(), dict(return_warp_jacobian=True, use_warp=True),
                 dict(use_warp=False)):
    want = jmodel.apply({'params': jparams},
                        jax.tree.map(jnp.asarray, rays), warp_extra=_EXTRA,
                        **kwargs)
    got = model(params, to_torch(rays), _EXTRA, **kwargs)
    for level in want:
      assert set(got[level]) == set(want[level]), (kwargs, level)
      np.testing.assert_allclose(got[level]['rgb'].detach().numpy(),
                                 np.asarray(want[level]['rgb']), atol=1e-5,
                                 rtol=1e-4)


def test_forward_with_encoded_metadata_matches_model_apply():
  """metadata_encoded: the rays carry the codes (warp, appearance, camera)
  in place of ids, through every condition and the warp field."""
  jmodel, jparams, model, params = model_pair(
      use_appearance_metadata=True, use_trunk_condition=True,
      use_rgb_condition=True, use_camera_metadata=True)
  rays = ray_batch()
  rng = np.random.RandomState(4)
  rays['metadata'] = {
      'warp': rng.uniform(0, 0.5, (8, 4)).astype(np.float32),
      'appearance': rng.uniform(0, 0.5, (8, 8)).astype(np.float32),
      'camera': rng.uniform(0, 0.5, (8, 2)).astype(np.float32)}
  want = jmodel.apply({'params': jparams}, jax.tree.map(jnp.asarray, rays),
                      warp_extra=_EXTRA, metadata_encoded=True)
  got = model(params, to_torch(rays), _EXTRA, metadata_encoded=True)
  for level in want:
    for key in ('rgb', 'depth', 'acc'):
      np.testing.assert_allclose(got[level][key].detach().numpy(),
                                 np.asarray(want[level][key]), atol=1e-5,
                                 rtol=1e-4, err_msg=f'{level}/{key}')


def _loss_and_grads(model, params, rays):
  leaves = dict(fused_mlp.flatten_tree(params))
  for t in leaves.values():
    t.requires_grad_(True)
  out = model(params, rays, _EXTRA, return_points=True, return_weights=True)
  loss = (out['fine']['rgb'].sum() + out['coarse']['rgb'].sum()
          + (out['coarse']['warp_jacobian'] ** 2).sum())
  grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
  return out, dict(zip(leaves, grads))


@pytest.mark.parametrize('policy', ['dots', 'none'])
def test_remat_gives_equal_outputs_and_gradients(policy):
  """use_remat recomputes (or, for 'dots', keeps the products of) the
  NeRF MLP and warp field in the backward: outputs and gradients equal
  to those without it."""
  fields = {**SMALL_MODEL, 'use_appearance_metadata': True,
            'use_alpha_condition': True, 'use_rgb_condition': True}
  rays = to_torch(ray_batch(seed=2))
  results = []
  for remat in (False, True):
    config = configs.ModelConfig(**fields, use_remat=remat,
                                 remat_policy=policy)
    model, params = nerf.construct_nerf(
        config, device='cpu', generator=torch.Generator().manual_seed(0),
        use_warp_jacobian=True, use_weights=True, **SMALL_IDS)
    results.append(_loss_and_grads(model, params, rays))
  (out_a, grads_a), (out_b, grads_b) = results
  for level in out_a:
    for key in out_a[level]:
      torch.testing.assert_close(out_b[level][key], out_a[level][key],
                                 rtol=0, atol=0)
  assert set(grads_a) == set(grads_b)
  for path, g in grads_a.items():
    assert g is not None, path
    torch.testing.assert_close(grads_b[path], g, rtol=1e-6, atol=1e-7)


def test_stratified_forward_draws_from_its_generators():
  fields = {**SMALL_MODEL, 'use_stratified_sampling': True,
            'noise_std': 0.1}
  model, params = nerf.construct_nerf(
      configs.ModelConfig(**fields), device='cpu',
      generator=torch.Generator().manual_seed(0), **SMALL_IDS)
  rays = to_torch(ray_batch())

  def run(seed):
    gens = [torch.Generator().manual_seed(seed + i) for i in range(2)]
    with torch.no_grad():
      return model(params, rays, _EXTRA, return_weights=True,
                   coarse_generator=gens[0], fine_generator=gens[1])

  first, again, other = run(0), run(0), run(5)
  for level, samples in (('coarse', 6), ('fine', 11)):
    assert first[level]['rgb'].shape == (8, 3)
    assert first[level]['weights'].shape == (8, samples)
    for key, value in first[level].items():
      assert torch.isfinite(value).all(), (level, key)
      torch.testing.assert_close(again[level][key], value, rtol=0, atol=0)
  assert not torch.equal(other['fine']['rgb'], first['fine']['rgb'])
  with pytest.raises(ValueError, match='generator per level'):
    model(params, rays, _EXTRA)
