"""The port's plain modules and warp fields against the Flax modules.

nerfies_tpu_torch.models.{modules, glo, warping} against
nerfies_tpu/models/{modules, glo, warping}.py on the CPU, at small
widths: the same params (drawn by Flax's init from a seed, or from numpy)
and the same inputs. Tolerances: float32 at atol 1e-5, rtol 1e-4;
Jacobians at atol 1e-4 (tests/test_models.py:123); bf16 at atol = rtol =
0.05 (tests/test_fused_mlp.py).
"""

import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu.models import glo as jax_glo
from nerfies_tpu.models import modules as jax_modules
from nerfies_tpu.models import warping as jax_warping
from nerfies_tpu_torch import interop
from nerfies_tpu_torch.models import glo
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.models import warping
from nerfies_tpu_torch.ops import fused_mlp
from tests.torch_parity import grad_check
from tests.torch_parity import to_torch

F32 = dict(atol=1e-5, rtol=1e-4)
BF16 = dict(atol=0.05, rtol=0.05)
JACOBIAN = dict(atol=1e-4, rtol=1e-4)
DTYPES = {'f32': (None, None, F32), 'bf16': (jnp.bfloat16, torch.bfloat16,
                                             BF16)}


def _normal(*shape, seed=0, scale=1.0):
  return (scale * np.random.RandomState(seed).normal(size=shape)).astype(
      np.float32)


def _init(module, *args, seed=0, **kwargs):
  """Flax params of `module` on `args`, as the port's tree (CPU tensors)."""
  params = module.init(jax.random.PRNGKey(seed), *args, **kwargs)['params']
  return params, interop.params_from_jax(params, device='cpu')


def _close(got, want, tol, msg=''):
  np.testing.assert_allclose(got.detach().float().numpy(),
                             np.asarray(want, np.float32), err_msg=msg,
                             **tol)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('rank', [2, 3])
def test_split_dense_matches_flax(rank, dtype):
  """A full-batch input and a per-ray one of lower rank; 2-D when
  rank = 2 (both full-batch)."""
  jdtype, tdtype, tol = DTYPES[dtype]
  shape = (5, 7) if rank == 3 else (5,)
  x = _normal(*shape, 6)
  c = _normal(5, 1, 4, seed=1) if rank == 3 else _normal(5, 4, seed=1)
  layer = jax_modules.SplitDense(9, dtype=jdtype)
  jparams, params = _init(layer, [jnp.asarray(x), jnp.asarray(c)])
  jparams = {**jparams, 'bias': jnp.asarray(_normal(9, seed=2))}
  params['bias'] = torch.from_numpy(np.array(jparams['bias']))
  want = layer.apply({'params': jparams}, [jnp.asarray(x), jnp.asarray(c)])
  got = modules.apply_split_dense(params, [torch.from_numpy(x),
                                           torch.from_numpy(c)], tdtype)
  assert tuple(got.shape) == want.shape
  assert got.dtype == (tdtype or torch.float32)
  _close(got, want, tol)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_mlp_with_skips_matches_flax(dtype):
  jdtype, tdtype, tol = DTYPES[dtype]
  x, code = _normal(4, 6, 5), _normal(4, 1, 3, seed=1)
  mlp = jax_modules.MLP(depth=4, width=16, skips=(2,), output_channels=3,
                        output_activation=nn.sigmoid, dtype=jdtype)
  inputs = [jnp.asarray(x), jnp.asarray(code)]
  jparams, params = _init(mlp, inputs)
  want = mlp.apply({'params': jparams}, inputs)
  got = modules.apply_mlp(params, [torch.from_numpy(x),
                                   torch.from_numpy(code)], skips=(2,),
                          output_activation=torch.sigmoid, dtype=tdtype)
  _close(got, want, tol)
  assert set(params) == set(modules.mlp([5, 3], 4, 16, (2,), 3))


_CONDITIONS = {
    'none': (0, 0, 0),
    'rgb': (0, 0, 5),
    'alpha_rgb': (0, 3, 5),
    'trunk': (3, 0, 0),
    'trunk_alpha_rgb': (3, 3, 5),
}


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('case', sorted(_CONDITIONS))
def test_nerf_mlp_matches_flax(case, dtype):
  jdtype, tdtype, tol = DTYPES[dtype]
  widths = _CONDITIONS[case]
  x = _normal(4, 6, 9)
  conds = [_normal(4, w, seed=i + 1) if w else None
           for i, w in enumerate(widths)]
  mlp = jax_modules.NerfMLP(trunk_depth=3, trunk_width=32,
                            rgb_branch_width=16, skips=(1,),
                            activation=nn.elu, dtype=jdtype)
  jargs = [jnp.asarray(x)] + [None if c is None else jnp.asarray(c)
                              for c in conds]
  jparams, params = _init(mlp, *jargs)
  want = mlp.apply({'params': jparams}, *jargs)
  got = modules.apply_nerf_mlp(
      params, torch.from_numpy(x),
      *[None if c is None else torch.from_numpy(c) for c in conds],
      skips=(1,), activation=torch.nn.functional.elu, dtype=tdtype)
  tree = modules.nerf_mlp(9, *widths, trunk_depth=3, trunk_width=32,
                          rgb_branch_width=16, skips=(1,))
  assert {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(params)} == \
      {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(tree)}
  for key in ('rgb', 'alpha'):
    assert got[key].dtype == torch.float32
    _close(got[key], want[key], tol, key)


@pytest.mark.parametrize('alpha', [None, 0.7])
def test_time_encoder_matches_flax(alpha):
  time = np.random.RandomState(0).uniform(size=(6, 1)).astype(np.float32)
  encoder = jax_modules.TimeEncoder(num_freqs=3, features=5)
  jparams, params = _init(encoder, jnp.asarray(time))
  want = encoder.apply({'params': jparams}, jnp.asarray(time), alpha)
  got = modules.apply_time_encoder(params, torch.from_numpy(time), 3, alpha)
  _close(got, want, F32)
  tree = modules.time_encoder(3, 5)
  assert {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(params)} == \
      {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(tree)}


def test_glo_matches_flax():
  ids = np.array([[0], [3], [2], [3]], np.uint32)
  encoder = jax_glo.GloEncoder(num_embeddings=4, features=6)
  jparams, params = _init(encoder, jnp.asarray(ids))
  want = encoder.apply({'params': jparams}, jnp.asarray(ids))
  got = glo.lookup(params, torch.from_numpy(ids.astype(np.int64)))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Each field: (field_type, metadata encoder, kwargs of the field).
_FIELDS = {
    'translation': ('translation', 'glo',
                    dict(depth=3, hidden_channels=32, skips=(2,))),
    'se3_fused_heads': ('se3', 'glo',
                        dict(trunk_depth=3, trunk_width=32, skips=(2,))),
    'se3_wv_depth_1': ('se3', 'glo',
                       dict(trunk_depth=3, trunk_width=32, skips=(2,),
                            rotation_depth=1, rotation_width=16,
                            pivot_depth=1, pivot_width=16)),
    'se3_pivot': ('se3', 'glo', dict(trunk_depth=3, trunk_width=32,
                                     use_pivot=True, pivot_width=16)),
    'se3_translation': ('se3', 'glo',
                        dict(trunk_depth=3, trunk_width=32,
                             use_translation=True, translation_depth=1,
                             translation_width=16)),
    'time': ('se3', 'time', dict(trunk_depth=3, trunk_width=32,
                                 metadata_encoder_num_freqs=2)),
    'blend': ('translation', 'blend',
              dict(depth=3, hidden_channels=32, skips=(2,))),
}
_EXTRA = {'alpha': 1.5, 'time_alpha': 0.4}


def _field_pair(name, dtype=None, seed=0):
  """The Flax field, its params (Flax init, then heads scaled up so the
  warp is far from the identity) and the port's view of the model."""
  field_type, encoder, kwargs = _FIELDS[name]
  field = jax_warping.create_warp_field(
      field_type, num_freqs=2, num_embeddings=3, num_features=4,
      metadata_encoder_type=encoder, dtype=dtype, **kwargs)
  points, metadata = _field_inputs(encoder)
  jparams = field.init(jax.random.PRNGKey(seed), jnp.asarray(points),
                       jnp.asarray(metadata), _EXTRA)['params']
  rng = np.random.RandomState(seed + 1)
  jparams = jax.tree_util.tree_map_with_path(
      lambda path, leaf: (jnp.asarray(rng.uniform(-0.3, 0.3, leaf.shape),
                                      jnp.float32)
                          if 'branches' in jax.tree_util.keystr(path)
                          or "['logit']" in jax.tree_util.keystr(path)
                          else leaf), jparams)
  model = types.SimpleNamespace(
      warp_field_type=field_type, num_warp_freqs=2, warp_kwargs=kwargs,
      warp_metadata_encoder_type=encoder)
  tree = warping.create_warp_field(field_type, 2, 3, 4, encoder, **kwargs)
  params = interop.params_from_jax(jparams, device='cpu')
  assert {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(params)} == \
      {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(tree)}
  return field, jparams, model, params


def _field_inputs(encoder, b=4, s=5):
  rng = np.random.RandomState(3)
  points = rng.uniform(-1, 1, (b, s, 3)).astype(np.float32)
  if encoder == 'time':
    return points, rng.uniform(size=(b, 1)).astype(np.float32)
  return points, rng.randint(0, 3, (b, 1)).astype(np.uint32)


@pytest.mark.parametrize('name', sorted(_FIELDS))
def test_warp_field_and_jacobian_match_flax(name):
  field, jparams, model, params = _field_pair(name)
  points, metadata = _field_inputs(model.warp_metadata_encoder_type)
  want = field.apply({'params': jparams}, jnp.asarray(points),
                     jnp.asarray(metadata), _EXTRA, True)
  got = warping.apply_field(model, params, torch.from_numpy(points),
                            to_torch(metadata), _EXTRA,
                            return_jacobian=True)
  _close(got['warped_points'], want['warped_points'], F32)
  assert tuple(got['jacobian'].shape) == (3, 3, 4, 5)
  _close(got['jacobian'], want['jacobian'], JACOBIAN)
  plain = warping.apply_field(model, params, torch.from_numpy(points),
                              to_torch(metadata), _EXTRA)
  assert set(plain) == {'warped_points'}
  torch.testing.assert_close(plain['warped_points'], got['warped_points'])
  # A warp far from the identity, so the check is not vacuous.
  assert float((got['warped_points'] - torch.from_numpy(points)).abs()
               .max()) > 0.05


@pytest.mark.parametrize('name', ['se3_pivot', 'translation'])
def test_warp_field_in_bf16_matches_flax(name):
  field, jparams, model, params = _field_pair(name, dtype=jnp.bfloat16)
  points, metadata = _field_inputs('glo')
  want = field.apply({'params': jparams}, jnp.asarray(points),
                     jnp.asarray(metadata), _EXTRA, True)
  got = warping.apply_field(model, params, torch.from_numpy(points),
                            to_torch(metadata), _EXTRA,
                            return_jacobian=True, dtype=torch.bfloat16)
  _close(got['warped_points'], want['warped_points'], BF16)
  _close(got['jacobian'], want['jacobian'], BF16)


@pytest.mark.parametrize('name', ['se3_fused_heads', 'blend'])
def test_elastic_gradient_through_the_jacobian_matches_flax(name):
  """d sum(J^2) / d params: the loss's gradient reaches every param of
  the field through the Jacobian, as through jax.linearize."""
  field, jparams, model, params = _field_pair(name)
  points, metadata = _field_inputs(model.warp_metadata_encoder_type)

  def jax_loss(p):
    out = field.apply({'params': p}, jnp.asarray(points),
                      jnp.asarray(metadata), _EXTRA, True)
    return jnp.sum(out['jacobian'] ** 2) + jnp.sum(out['warped_points'])

  want = jax.grad(jax_loss)(jparams)
  leaves = {p: t.requires_grad_(True)
            for p, t in fused_mlp.flatten_tree(params)}
  out = warping.apply_field(model, params, torch.from_numpy(points),
                            to_torch(metadata), _EXTRA,
                            return_jacobian=True)
  loss = (out['jacobian'] ** 2).sum() + out['warped_points'].sum()
  grads = torch.autograd.grad(loss, list(leaves.values()),
                              allow_unused=True)
  got = fused_mlp.unflatten_tree(
      list(leaves), [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves.values(), grads)])
  grad_check(got, want, 'd sum(J^2)', cos_floor=0.9999)
