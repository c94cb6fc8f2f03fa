"""The port's rigid-body and scalar-map helpers against the JAX package's,
in float32 on the CPU, and the closed forms of tests/test_rigid.py and
tests/test_mathutils.py repeated on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from nerfies_tpu.ops import mathutils as jax_mathutils
from nerfies_tpu.ops import rigid as jax_rigid
from nerfies_tpu_torch.ops import mathutils
from nerfies_tpu_torch.ops import rigid
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# float32 elementwise math in both frameworks: a few ulps apart.
ATOL, RTOL = 1e-6, 1e-5


def _unit(rng, n):
  axis = rng.randn(n, 3)
  return (axis / np.linalg.norm(axis, axis=-1, keepdims=True)).astype(
      np.float32)


def _screws(rng, n):
  return np.concatenate([_unit(rng, n), rng.randn(n, 3).astype(np.float32)],
                        axis=-1)


def _f32(rng, low, high, shape):
  return rng.uniform(low, high, shape).astype(np.float32)


# name: (module, inputs from a RandomState, keyword arguments).
CASES = {
    'skew': (rigid, lambda r: (r.randn(17, 3).astype(np.float32),), {}),
    'exp_so3': (rigid, lambda r: (_unit(r, 32), _f32(r, 0.01, np.pi, 32)),
                {}),
    'exp_se3': (rigid, lambda r: (_screws(r, 16), _f32(r, 0.0, 2.0, 16)), {}),
    'rp_to_se3': (rigid, lambda r: (r.randn(8, 3, 3).astype(np.float32),
                                    r.randn(8, 3).astype(np.float32)), {}),
    'se3_apply': (rigid, lambda r: (_screws(r, 16), _f32(r, 0.0, 2.0, 16),
                                    r.randn(16, 3).astype(np.float32)), {}),
    'to_homogenous': (rigid, lambda r: (r.randn(7, 3).astype(np.float32),),
                      {}),
    'from_homogenous': (rigid, lambda r: (np.concatenate(
        [r.randn(7, 3), r.uniform(0.5, 2.0, (7, 1))], -1).astype(
            np.float32),), {}),
    # Past 87.5 both clamp.
    'exp_safe': (mathutils, lambda r: (_f32(r, -100.0, 100.0, 64),), {}),
    'logit': (mathutils, lambda r: (_f32(r, 0.01, 0.99, 64),), {}),
    'affine_sigmoid': (mathutils, lambda r: (r.randn(64).astype(np.float32)
                                             * 3,), dict(lo=-2.0, hi=3.0)),
    'inv_affine_sigmoid': (mathutils, lambda r: (_f32(r, -1.9, 2.9, 64),),
                           dict(lo=-2.0, hi=3.0)),
    # Past 87.5 the identity.
    'inv_softplus': (mathutils, lambda r: (_f32(r, 0.01, 100.0, 64),), {}),
    'affine_softplus': (mathutils, lambda r: (r.randn(64).astype(np.float32)
                                              * 3,), dict(lo=0.5, ref=2.0)),
    'inv_affine_softplus': (mathutils, lambda r: (_f32(r, 0.51, 50.0, 64),),
                            dict(lo=0.5, ref=2.0)),
}
JAX_MODULES = {rigid: jax_rigid, mathutils: jax_mathutils}


@pytest.mark.parametrize('name', sorted(CASES))
def test_helper_matches_jax(name):
  module, make_inputs, kwargs = CASES[name]
  inputs = make_inputs(np.random.RandomState(sorted(CASES).index(name)))
  want = getattr(JAX_MODULES[module], name)(
      *[jnp.asarray(x) for x in inputs], **kwargs)
  got = getattr(module, name)(*[torch.from_numpy(x) for x in inputs],
                              **kwargs)
  assert got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=RTOL)


def _t(x):
  return torch.as_tensor(np.asarray(x, np.float32))


def _skew_is_the_cross_product():
  rng = np.random.RandomState(0)
  w, v = rng.randn(17, 3), rng.randn(17, 3)
  got = torch.einsum('bij,bj->bi', rigid.skew(_t(w)), _t(v))
  np.testing.assert_allclose(got.numpy(), np.cross(w, v), atol=1e-5)


def _exp_so3_is_scipys_rotation():
  rng = np.random.RandomState(1)
  axis = _unit(rng, 32)
  theta = rng.uniform(0.01, np.pi - 0.01, 32)
  want = Rotation.from_rotvec(axis * theta[:, None]).as_matrix()
  np.testing.assert_allclose(rigid.exp_so3(_t(axis), _t(theta)).numpy(),
                             want, atol=1e-5)


def _exp_se3_is_a_rigid_transform():
  rng = np.random.RandomState(2)
  T = rigid.exp_se3(_t(_screws(rng, 8)), _t(rng.uniform(0.1, 2.0, 8)))
  R = T[:, :3, :3]
  np.testing.assert_allclose((R.transpose(-1, -2) @ R).numpy(),
                             np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-5)
  np.testing.assert_array_equal(T[:, 3].numpy(), np.tile([0, 0, 0, 1], (8, 1)))


def _exp_se3_at_zero_is_the_identity():
  S = _t(np.concatenate([np.tile([1.0, 0, 0], (4, 1)),
                         np.random.RandomState(3).randn(4, 3)], -1))
  np.testing.assert_allclose(rigid.exp_se3(S, torch.zeros(4)).numpy(),
                             np.broadcast_to(np.eye(4), (4, 4, 4)), atol=1e-6)


def _se3_apply_is_the_matrix_route():
  rng = np.random.RandomState(4)
  S, theta = _t(_screws(rng, 16)), _t(rng.uniform(0.0, 2.0, 16))
  points = _t(rng.randn(16, 3))
  want = rigid.from_homogenous(
      (rigid.exp_se3(S, theta) @ rigid.to_homogenous(points)[..., None])[
          ..., 0])
  np.testing.assert_allclose(rigid.se3_apply(S, theta, points).numpy(),
                             want.numpy(), atol=1e-5)


def _se3_apply_raw_is_the_normalised_form():
  rng = np.random.RandomState(0)
  w = rng.randn(32, 3).astype(np.float32)
  v = rng.randn(32, 3).astype(np.float32) * 0.1
  p = rng.randn(32, 3).astype(np.float32)
  theta = np.linalg.norm(w, axis=-1)
  S = np.concatenate([w, v], -1) / theta[:, None]
  np.testing.assert_allclose(
      rigid.se3_apply_raw(_t(w), _t(v), _t(p)).numpy(),
      rigid.se3_apply(_t(S), _t(theta), _t(p)).numpy(), atol=1e-5)


def _homogenous_round_trip():
  x = _t(np.random.RandomState(5).randn(7, 3))
  np.testing.assert_allclose(
      rigid.from_homogenous(rigid.to_homogenous(x)).numpy(), x.numpy(),
      atol=1e-7)


def _exp_so3_gradient_matches_jax():
  axis = np.array([[0.0, 0.0, 1.0]], np.float32)
  want = jax.grad(lambda t: jax_rigid.exp_so3(jnp.asarray(axis), t[None])[
      0].sum())(jnp.float32(0.3))
  theta = torch.tensor(0.3, requires_grad=True)
  got, = torch.autograd.grad(
      rigid.exp_so3(_t(axis), theta[None])[0].sum(), theta)
  assert np.isfinite(got.numpy())
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _sigmoid_maps_round_trip():
  x = _t(np.random.RandomState(6).randn(64) * 3)
  np.testing.assert_allclose(mathutils.logit(torch.sigmoid(x)).numpy(),
                             x.numpy(), atol=1e-4)
  y = mathutils.affine_sigmoid(x, lo=-2.0, hi=3.0)
  assert float(y.min()) > -2.0 and float(y.max()) < 3.0
  np.testing.assert_allclose(
      mathutils.inv_affine_sigmoid(y, lo=-2.0, hi=3.0).numpy(), x.numpy(),
      atol=1e-4)
  np.testing.assert_allclose(
      float(mathutils.affine_sigmoid(torch.zeros(()), lo=-2.0, hi=3.0)), 0.5,
      atol=1e-7)


def _softplus_maps_round_trip():
  x = _t(np.random.RandomState(7).randn(64) * 3)
  np.testing.assert_allclose(
      mathutils.inv_softplus(torch.nn.functional.softplus(x)).numpy(),
      x.numpy(), atol=1e-4)
  y = mathutils.affine_softplus(x, lo=0.5, ref=2.0)
  assert float(y.min()) > 0.5
  np.testing.assert_allclose(
      mathutils.inv_affine_softplus(y, lo=0.5, ref=2.0).numpy(), x.numpy(),
      atol=1e-4)
  np.testing.assert_allclose(
      float(mathutils.affine_softplus(torch.zeros(()), lo=0.5, ref=2.0)), 2.0,
      atol=1e-6)
  big = _t([87.4, 87.6, 1e4])
  assert torch.isfinite(mathutils.inv_softplus(big)).all()
  np.testing.assert_array_equal(mathutils.inv_softplus(big)[1:].numpy(),
                                big[1:].numpy())
  np.testing.assert_array_equal(mathutils.exp_safe(big)[1:].numpy(),
                                torch.exp(_t([87.5, 87.5])).numpy())


CLOSED_FORMS = [_skew_is_the_cross_product, _exp_so3_is_scipys_rotation,
                _exp_se3_is_a_rigid_transform,
                _exp_se3_at_zero_is_the_identity,
                _se3_apply_is_the_matrix_route,
                _se3_apply_raw_is_the_normalised_form,
                _homogenous_round_trip, _exp_so3_gradient_matches_jax,
                _sigmoid_maps_round_trip, _softplus_maps_round_trip]


@pytest.mark.parametrize('check', CLOSED_FORMS,
                         ids=lambda f: f.__name__.lstrip('_'))
def test_closed_form(check):
  check()


@pytest.mark.parametrize('name,bounds', [
    ('affine_sigmoid', dict(lo=1.0, hi=1.0)),
    ('inv_affine_sigmoid', dict(lo=2.0, hi=1.0)),
    ('affine_softplus', dict(lo=1.0, ref=1.0)),
    ('inv_affine_softplus', dict(lo=2.0, ref=1.0)),
])
def test_bounds_out_of_order_raise(name, bounds):
  x = np.full(3, 0.5, np.float32)
  with pytest.raises(ValueError, match='must be <'):
    getattr(jax_mathutils, name)(jnp.asarray(x), **bounds)
  with pytest.raises(ValueError, match='must be <'):
    getattr(mathutils, name)(torch.from_numpy(x), **bounds)
