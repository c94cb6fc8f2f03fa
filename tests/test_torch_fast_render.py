"""The port's serving render against the JAX package's, on the CPU.

One JAX param tree (random values in the names and shapes of the JAX
construct_nerf) goes through interop.params_from_jax to the port. The
JAX side runs its Pallas kernels in the interpreter; the port runs the
plain versions of its kernels, as its wrappers do on a CPU tensor.
"""

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch
import test_fused_train
import torch_parity

from nerfies_tpu import configs as jax_configs
from nerfies_tpu import evaluation as jax_evaluation
from nerfies_tpu import fast_render as jax_fast_render
from nerfies_tpu import training
from nerfies_tpu.parallel import mesh as mesh_lib
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import fast_render
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.models import nerf

# The tolerance of tests/test_fast_render.py for the same outputs.
ATOL, RTOL = 0.02, 0.05
_IDS = dict(appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
            near=0.5, far=3.0)


def _kwargs(warp_field_type):
  return dict(
      num_coarse_samples=8,
      num_fine_samples=8,
      nerf_trunk_depth=3,
      nerf_trunk_width=32,
      nerf_rgb_branch_depth=1,
      nerf_rgb_branch_width=16,
      nerf_skips=(2,),
      num_nerf_point_freqs=3,
      num_nerf_viewdir_freqs=2,
      num_warp_freqs=2,
      use_warp=True,
      warp_field_type=warp_field_type,
      warp_kwargs=({'trunk_depth': 3, 'skips': (2,)}
                   if warp_field_type == 'se3'
                   else {'depth': 3, 'skips': (2,), 'hidden_channels': 32}),
      use_appearance_metadata=True,
      use_camera_metadata=True,
      use_alpha_condition=True,
      use_rgb_condition=True,
      use_stratified_sampling=False,
  )


def _build(warp_field_type='se3'):
  """(jax model, jax params, port model, port params) from one JAX tree."""
  kwargs = _kwargs(warp_field_type)
  jax_model, shapes = torch_parity.jax_model_and_shapes(
      jax_configs.ModelConfig(sigma_activation=nn.softplus,
                              use_bfloat16=True, **kwargs),
      **_IDS)
  jax_params = torch_parity.random_params(shapes)
  params = interop.params_from_jax(jax_params, device='cpu')
  config = configs.ModelConfig(sigma_activation='softplus', **kwargs)
  model = nerf.NerfModel(config, params, **_IDS)
  return jax_model, jax_params, model, model.params


def _rays(batch=12, seed=0):
  rng = np.random.RandomState(seed)
  directions = rng.normal(size=(batch, 3)).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  return {
      'origins': rng.normal(scale=0.1, size=(batch, 3)).astype(np.float32),
      'directions': directions,
      'metadata': {
          'warp': rng.randint(0, 2, (batch, 1)).astype(np.uint32),
          'appearance': rng.randint(0, 2, (batch, 1)).astype(np.uint32),
          'camera': np.zeros((batch, 1), np.uint32),
      },
  }


def _torch_rays(rays):
  return {k: (_torch_rays(v) if isinstance(v, dict) else
              torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                               else v)) for k, v in rays.items()}


_WARP_EXTRA = {'alpha': 1.5, 'time_alpha': 0.0}


@pytest.mark.parametrize('field', ['se3', 'translation'])
def test_render_rays_matches_pallas(field):
  jax_model, jax_params, model, params = _build(field)
  assert fast_render.supported(model)
  rays = _rays()
  want = jax_fast_render.render_rays(
      jax_params, jax.tree.map(jax.numpy.asarray, rays), _WARP_EXTRA,
      jax_model, interpret=True, mlp='pallas', return_weights=True)
  got = fast_render.render_rays(params, _torch_rays(rays), _WARP_EXTRA,
                                model, return_weights=True)
  assert set(got) == set(want) == {'coarse', 'fine'}
  for level in want:
    assert set(got[level]) == set(want[level])
    for key in ('rgb', 'depth', 'med_depth', 'acc', 'weights'):
      np.testing.assert_allclose(
          got[level][key].numpy(), np.asarray(want[level][key]),
          atol=ATOL, rtol=RTOL, err_msg=f'{field} {level}/{key}')


def _image_rays(h, w, seed=5):
  flat = _rays(h * w, seed)
  return {k: ({kk: vv.reshape(h, w, -1) for kk, vv in v.items()}
              if isinstance(v, dict) else v.reshape(h, w, -1))
          for k, v in flat.items()}


def test_render_image_matches_jax():
  jax_model, jax_params, model, params = _build('se3')
  rays = _image_rays(6, 7)
  state = training.create_train_state(jax_params, warp_alpha=1.5)
  jax_fn = jax_evaluation.make_render_fn(jax_model, mesh_lib.create_mesh())
  want = jax_evaluation.render_image(state, rays, jax_fn, chunk=16)
  got = evaluation.render_image(
      evaluation.RenderState(params, warp_alpha=1.5), rays,
      evaluation.make_render_fn(model, device='cpu'), chunk=16)
  for key in ('rgb', 'depth', 'med_depth', 'acc'):
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL,
                               err_msg=key)
  assert got['rays_per_sec'] > 0 and got['render_time'] > 0


def test_render_image_chunk_invariance():
  _, _, model, params = _build('translation')
  rays = _image_rays(5, 9, seed=6)
  state = evaluation.RenderState(params, warp_alpha=1.5)
  fn = evaluation.make_render_fn(model, device='cpu')
  whole = evaluation.render_image(state, rays, fn, chunk=4096)
  odd = evaluation.render_image(state, rays, fn, chunk=7)
  for key in ('rgb', 'depth', 'med_depth', 'acc'):
    assert odd[key].shape[:2] == (5, 9)
    # Rows are independent, so a ray's output does not depend on its chunk.
    np.testing.assert_allclose(odd[key], whole[key], atol=1e-6, rtol=1e-6)


def test_unported_options_raise():
  _, _, model, params = _build('se3')
  rays = _torch_rays(_rays())
  with pytest.raises(NotImplementedError):
    fast_render.render_rays(params, rays, _WARP_EXTRA, model,
                            keep_samples=(4, 4))


# The warp encoding's kwargs. The serving warp encodes the points as the
# warp field does (min_freq_log2, max_freq_log2, use_identity_map), so it
# is held to the JAX model.apply warp; the JAX fast_render encodes with
# num_freqs and alpha only (nerfies_tpu/fast_render.py:83-84), which
# diverges there: use_identity_map=False misaligns its layer-0 split by the
# 3 identity rows, and max_freq_log2 changes the frequencies.
_WARP_KWARG_CASES = {
    'no_identity_map': {'use_identity_map': False},
    'max_freq_log2': {'max_freq_log2': 3.0},
}


@pytest.mark.parametrize('case', sorted(_WARP_KWARG_CASES))
def test_serving_warp_honours_the_encoding_kwargs(case):
  warp_kwargs = {'trunk_depth': 3, 'skips': (2,), **_WARP_KWARG_CASES[case]}
  jmodel, jparams = test_fused_train._build(warp_kwargs=warp_kwargs)
  # The model's init with a warp head at the scale of
  # tests/test_torch_fused_warp.py's (the 1e-4 init would hide the warp).
  rng = np.random.RandomState(4)
  head = jparams['warp_field']['branches_wv']['logit']
  head = {'kernel': np.float32(0.1) * rng.normal(
              size=head['kernel'].shape).astype(np.float32),
          'bias': np.full(head['bias'].shape, 0.01, np.float32)}
  jparams = {**jparams, 'warp_field': {
      **jparams['warp_field'], 'branches_wv': {'logit': head}}}
  model = torch_parity.port_model('se3', warp_kwargs)
  points = rng.uniform(-1, 1, (4, 6, 3)).astype(np.float32)
  ids = rng.randint(0, 2, (4, 1)).astype(np.uint32)
  want = np.asarray(jmodel.apply(
      {'params': jparams}, jax.numpy.asarray(points), jax.numpy.asarray(ids),
      _WARP_EXTRA, False, False, method=jmodel.apply_warp)['warped_points'])
  got = fast_render._apply_warp_fused(
      interop.params_from_jax(jparams, device='cpu'), model,
      torch.from_numpy(points), torch.from_numpy(ids.astype(np.int64)),
      _WARP_EXTRA)
  # The warp tolerance of tests/test_fused_warp.py.
  np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-2)

  try:
    jax_got = np.asarray(jax_fast_render._apply_warp_fused(
        jparams, jmodel, jax.numpy.asarray(points), jax.numpy.asarray(ids),
        _WARP_EXTRA, interpret=True))
  except TypeError:  # the embedding rows no longer match the split
    assert case == 'no_identity_map'
  else:
    assert not np.allclose(jax_got, want, atol=2e-3, rtol=1e-2), case
