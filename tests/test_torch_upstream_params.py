"""interop.map_reference_params of the port against the JAX package's.

An upstream google/nerfies param tree (MLP_0/1/2, separate w and v
heads), made here with numpy from a JAX tree of the small model by the
inverse renaming, maps to the same tree through both packages, depth-0
heads fused into `branches_wv` and deep branches kept; the port's
NerfModel.forward over the mapped tree matches JAX's `model.apply` on 64
rays with deterministic sampling at atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerfies_tpu import interop as jax_interop
from nerfies_tpu_torch import interop
from tests.torch_parity import SMALL_MODEL
from tests.torch_parity import model_pair
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import ray_batch
from tests.torch_parity import to_torch

_EXTRA = {'alpha': 1.5, 'time_alpha': 0.0}
_BRANCHES = {
    'fused_heads': {},
    'deep_branches': {'rotation_depth': 1, 'rotation_width': 16,
                      'pivot_depth': 1, 'pivot_width': 16},
}


def _to_reference(tree):
  """The package's layout -> the upstream layout (numpy leaves)."""
  out = {}
  for key, value in tree.items():
    value = jax.tree.map(np.asarray, dict(value)) if isinstance(
        value, dict) else np.asarray(value)
    if key.startswith('nerf_mlps_'):
      mlp = {'MLP_0': {}, 'MLP_1': {}, 'MLP_2': {}}
      for name, layer in value.items():
        if name == 'bottleneck':
          mlp['bottleneck'] = layer
          continue
        prefix, sub = name.split('_', 1)
        mlp[{'trunk': 'MLP_0', 'rgb': 'MLP_1', 'alpha': 'MLP_2'}[prefix]][
            sub] = layer
      out[key] = mlp
    elif key == 'warp_field' and 'branches_wv' in value:
      field = {k: v for k, v in value.items() if k != 'branches_wv'}
      logit = value['branches_wv']['logit']
      field['branches_w'] = {'logit': {'kernel': logit['kernel'][:, :3],
                                       'bias': logit['bias'][:3]}}
      field['branches_v'] = {'logit': {'kernel': logit['kernel'][:, 3:],
                                       'bias': logit['bias'][3:]}}
      out[key] = field
    else:
      out[key] = value
  return out


def _assert_trees_equal(got, want, where=''):
  assert isinstance(got, dict) == isinstance(want, dict), where
  if isinstance(want, dict):
    assert set(got) == set(want), where
    for key in want:
      _assert_trees_equal(got[key], want[key], f'{where}/{key}')
  else:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=where)


@pytest.mark.parametrize('branches', sorted(_BRANCHES))
def test_mapped_upstream_tree_matches_jax(branches):
  warp_kwargs = {**SMALL_MODEL['warp_kwargs'], **_BRANCHES[branches]}
  jmodel, jparams, model, _ = model_pair(
      seed=3, use_warp_jacobian=False, use_weights=False,
      use_appearance_metadata=True, use_camera_metadata=True,
      use_alpha_condition=True, use_rgb_condition=True,
      warp_kwargs=warp_kwargs)
  reference = _to_reference(jparams)
  assert 'MLP_0' in reference['nerf_mlps_coarse']
  assert 'branches_w' in reference['warp_field']
  got = interop.map_reference_params(reference)
  want = jax_interop.map_reference_params(reference)
  _assert_trees_equal(got, want)
  _assert_trees_equal(got, jparams)  # the inverse renaming's round trip
  assert ('branches_wv' in got['warp_field']) == (branches == 'fused_heads')
  # Without fusing, the depth-0 heads stay apart in both packages.
  _assert_trees_equal(
      interop.map_reference_params(reference, fuse_branch_heads=False),
      jax_interop.map_reference_params(reference, fuse_branch_heads=False))

  rays = ray_batch(num_rays=64, seed=5)
  want_out = jmodel.apply({'params': want}, jax.tree.map(jnp.asarray, rays),
                          warp_extra=_EXTRA)
  got_out = model(interop.params_from_jax(got, 'cpu'), to_torch(rays),
                  _EXTRA)
  for level in ('coarse', 'fine'):
    for key in ('rgb', 'depth', 'acc'):
      np.testing.assert_allclose(
          got_out[level][key].detach().numpy(),
          np.asarray(want_out[level][key]), atol=1e-5, rtol=1e-4,
          err_msg=f'{level}/{key}')
