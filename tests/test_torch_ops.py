"""The port's tensor ops against the JAX package's, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu.ops import encoding as jax_encoding
from nerfies_tpu.ops import mathutils as jax_mathutils
from nerfies_tpu.ops import rendering as jax_rendering
from nerfies_tpu.ops import rigid as jax_rigid
from nerfies_tpu.ops import svd3 as jax_svd3
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import mathutils
from nerfies_tpu_torch.ops import rendering
from nerfies_tpu_torch.ops import rigid
from nerfies_tpu_torch.ops import svd3

# float32 elementwise math in both frameworks: a few ulps apart.
ATOL, RTOL = 1e-5, 1e-5


def _close(got, want, atol=ATOL, rtol=RTOL):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                             rtol=rtol)


@pytest.mark.parametrize('alpha', [None, 0.0, 2.5, 8.0])
@pytest.mark.parametrize('use_identity', [True, False])
def test_posenc_matches(alpha, use_identity):
  x = np.random.RandomState(0).uniform(-1, 1, (5, 7, 3)).astype(np.float32)
  want = jax_encoding.posenc(jnp.asarray(x), 8, use_identity=use_identity,
                             alpha=alpha)
  got = encoding.posenc(torch.from_numpy(x), 8, use_identity=use_identity,
                        alpha=alpha)
  assert got.shape[-1] == encoding.posenc_output_dim(3, 8, use_identity)
  _close(got, want)


def test_posenc_widths_of_the_bench_model():
  assert encoding.posenc_output_dim(3, 8) == 51
  assert encoding.posenc_output_dim(3, 6) == 39
  assert encoding.posenc_output_dim(3, 4) == 27


@pytest.mark.parametrize('alpha', [0.0, 0.3, 1.0, 3.7, 6.0])
def test_cosine_easing_window_matches(alpha):
  want = jax_encoding.cosine_easing_window(6, alpha)
  _close(encoding.cosine_easing_window(6, alpha), want)


# theta^2 around 0, the 0.005 clamp and the 0.01 Taylor switch, and large.
@pytest.mark.parametrize('theta_sq', [0.0, 1e-8, 1e-4, 0.0049, 0.0051,
                                      0.0099, 0.0101, 0.25, 4.0])
def test_se3_apply_raw_matches(theta_sq):
  rng = np.random.RandomState(1)
  axis = rng.normal(size=(64, 3)).astype(np.float32)
  axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
  w = (axis * np.sqrt(theta_sq)).astype(np.float32)
  v = rng.normal(size=(64, 3)).astype(np.float32)
  p = rng.normal(size=(64, 3)).astype(np.float32)
  want = jax_rigid.se3_apply_raw(jnp.asarray(w), jnp.asarray(v),
                                 jnp.asarray(p))
  got = rigid.se3_apply_raw(torch.from_numpy(w), torch.from_numpy(v),
                            torch.from_numpy(p))
  _close(got, want)


@pytest.mark.parametrize('use_linear_disparity', [False, True])
def test_sample_along_rays_matches(use_linear_disparity):
  rng = np.random.RandomState(2)
  o = rng.normal(size=(6, 3)).astype(np.float32)
  d = rng.normal(size=(6, 3)).astype(np.float32)
  want_z, want_p = jax_rendering.sample_along_rays(
      None, jnp.asarray(o), jnp.asarray(d), 16, 0.5, 3.0, False,
      use_linear_disparity)
  got_z, got_p = rendering.sample_along_rays(
      torch.from_numpy(o), torch.from_numpy(d), 16, 0.5, 3.0,
      use_linear_disparity)
  _close(got_z, want_z)
  _close(got_p, want_p)


def _render_inputs(seed=3, b=6, s=16):
  rng = np.random.RandomState(seed)
  rgb = rng.uniform(size=(b, s, 3)).astype(np.float32)
  sigma = rng.exponential(2.0, size=(b, s)).astype(np.float32)
  z = np.sort(rng.uniform(0.5, 3.0, size=(b, s)), axis=-1).astype(np.float32)
  d = rng.normal(size=(b, 3)).astype(np.float32)
  return rgb, sigma, z, d


@pytest.mark.parametrize('sample_at_infinity', [True, False])
@pytest.mark.parametrize('white', [False, True])
def test_volumetric_rendering_matches(sample_at_infinity, white):
  rgb, sigma, z, d = _render_inputs()
  want = jax_rendering.volumetric_rendering(
      jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(z), jnp.asarray(d),
      use_white_background=white, sample_at_infinity=sample_at_infinity,
      return_weights=True)
  got = rendering.volumetric_rendering(
      torch.from_numpy(rgb), torch.from_numpy(sigma), torch.from_numpy(z),
      torch.from_numpy(d), use_white_background=white,
      sample_at_infinity=sample_at_infinity, return_weights=True)
  assert set(got) == set(want)
  for key in want:
    _close(got[key], want[key])


def test_sample_pdf_matches():
  rng = np.random.RandomState(4)
  b, s = 8, 17
  z = np.sort(rng.uniform(0.5, 3.0, size=(b, s)), axis=-1).astype(np.float32)
  weights = rng.exponential(size=(b, s)).astype(np.float32)
  weights[0] = 0.0  # a ray with no mass: every bin degenerate
  weights[1, 3:9] = 0.0
  o = rng.normal(size=(b, 3)).astype(np.float32)
  d = rng.normal(size=(b, 3)).astype(np.float32)
  mids = 0.5 * (z[:, 1:] + z[:, :-1])
  want_z, want_p = jax_rendering.sample_pdf(
      None, jnp.asarray(mids), jnp.asarray(weights[:, 1:-1]),
      jnp.asarray(o), jnp.asarray(d), jnp.asarray(z), 12, False)
  got_z, got_p = rendering.sample_pdf(
      torch.from_numpy(mids), torch.from_numpy(weights[:, 1:-1]),
      torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(z), 12)
  # The JAX side gathers with a one-hot matmul at HIGHEST precision; the
  # interpolation then matches to a few ulps of the depth range.
  _close(got_z, want_z, atol=1e-5, rtol=1e-5)
  _close(got_p, want_p, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------ train-time ops

def _t(a):
  return torch.from_numpy(np.asarray(a, np.float32))


def test_posenc_tangents_match_jax_linearize():
  x = np.random.RandomState(6).uniform(-1, 1, (4, 5, 3)).astype(np.float32)
  fn = lambda p: jax_encoding.posenc(p, 6, use_identity=True, alpha=2.5)
  want_pe, jvp = jax.linearize(fn, jnp.asarray(x))
  got_pe, tangents = encoding.posenc_with_tangents(_t(x), 6, alpha=2.5)
  _close(got_pe, want_pe)
  assert len(tangents) == 3
  for j, t in enumerate(tangents):
    e = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32)[j], x.shape)
    # The slope is cos(angle) * freq: up to 32 at 6 bands, so float32
    # ulps of the angle scale with it.
    _close(t, jvp(e), atol=1e-4, rtol=1e-5)


def test_se3_apply_raw_double_backward_matches_jax():
  """The elastic loss differentiates through the linearized SE(3) action:
  gradients of a Jacobian loss, finite at w = 0 and equal to JAX's."""
  rng = np.random.RandomState(7)
  w = rng.normal(size=(16, 3)).astype(np.float32) * 0.3
  w[:4] = 0.0                      # the identity rotation
  w[4:8] *= 1e-3                   # inside the Taylor branch
  v = rng.normal(size=(16, 3)).astype(np.float32)
  p = rng.normal(size=(16, 3)).astype(np.float32)
  jw = rng.normal(size=(3, 16, 3)).astype(np.float32)
  jv = rng.normal(size=(3, 16, 3)).astype(np.float32)
  eye = np.eye(3, dtype=np.float32)

  def jax_loss(w, v, jw, jv):
    _, lin = jax.linearize(jax_rigid.se3_apply_raw, w, v, jnp.asarray(p))
    cols = [lin(jw[j], jv[j], jnp.broadcast_to(eye[j], p.shape))
            for j in range(3)]
    return sum(jnp.sum((c - eye[j]) ** 2) for j, c in enumerate(cols))

  want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
      jnp.asarray(w), jnp.asarray(v), jnp.asarray(jw), jnp.asarray(jv))
  tw, tv, tjw, tjv = (_t(a).requires_grad_(True) for a in (w, v, jw, jv))
  loss = 0.0
  for j in range(3):
    _, col = torch.func.jvp(rigid.se3_apply_raw, (tw, tv, _t(p)),
                            (tjw[j], tjv[j], _t(eye[j]).expand(16, 3)))
    loss = loss + ((col - _t(eye[j])) ** 2).sum()
  got = torch.autograd.grad(loss, (tw, tv, tjw, tjv))
  for g, w_ in zip(got, want):
    assert torch.isfinite(g).all()
    _close(g, w_)


def test_safe_norm_gradient_is_zero_at_the_origin():
  x = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], np.float32)
  want = jax.grad(lambda a: jax_mathutils.safe_norm(a).sum())(jnp.asarray(x))
  tx = _t(x).requires_grad_(True)
  got, = torch.autograd.grad(mathutils.safe_norm(tx).sum(), tx)
  _close(mathutils.safe_norm(_t(x)), jax_mathutils.safe_norm(jnp.asarray(x)))
  _close(got, want)
  assert float(got[0].abs().sum()) == 0.0


def _jacobians(seed=8, n=40):
  """(3, 3, n) Jacobians: near-identity, random, and reflecting."""
  rng = np.random.RandomState(seed)
  j = np.eye(3, dtype=np.float32)[..., None] + 0.3 * rng.normal(
      size=(3, 3, n)).astype(np.float32)
  j[:, :, :5] = rng.normal(size=(3, 3, 5))
  j[0, :, 5:10] *= -1.0  # det < 0
  j[:, :, 10] = np.eye(3)  # exactly the identity
  return j.astype(np.float32)


def test_jacobian_operators_match():
  j = _jacobians()
  _close(mathutils.jacobian_to_curl(_t(j)),
         jax_mathutils.jacobian_to_curl(jnp.asarray(j)))
  _close(mathutils.jacobian_to_div(_t(j)),
         jax_mathutils.jacobian_to_div(jnp.asarray(j)))
  mse = np.array([0.5, 0.01, 1e-4], np.float32)
  _close(mathutils.compute_psnr(_t(mse)),
         jax_mathutils.compute_psnr(jnp.asarray(mse)))
  sq = np.array([0.0, 1e-9, 2.0], np.float32)
  _close(mathutils.safe_sqrt(_t(sq)), jax_mathutils.safe_sqrt(jnp.asarray(sq)))


@pytest.mark.parametrize('alpha', [-np.inf, -2.0, -0.5, 0.0, 1.0, 2.0, 4.0,
                                   np.inf])
def test_general_loss_matches(alpha):
  sq = np.random.RandomState(9).exponential(0.01, size=64).astype(np.float32)
  sq[0] = 0.0

  def jax_fn(s):
    return jax_mathutils.general_loss_with_squared_residual(
        s, alpha=alpha, scale=0.1).sum()

  want_value = jax_mathutils.general_loss_with_squared_residual(
      jnp.asarray(sq), alpha=alpha, scale=0.1)
  want_grad = jax.grad(jax_fn)(jnp.asarray(sq))
  ts = _t(sq).requires_grad_(True)
  got = mathutils.general_loss_with_squared_residual(ts, alpha=alpha,
                                                     scale=0.1)
  grad, = torch.autograd.grad(got.sum(), ts)
  _close(got.detach(), want_value)
  _close(grad, want_grad)


@pytest.mark.parametrize('name', ['svals3', 'det3', 'inv3',
                                  'nearest_rotation'])
def test_svd3_matches(name):
  j = _jacobians()
  want = getattr(jax_svd3, name)(jnp.asarray(j))
  got = getattr(svd3, name)(_t(j))
  assert got.shape == want.shape
  _close(got, want)


def test_svd3_layout_round_trip():
  j = _jacobians()
  trailing = svd3.to_trailing(_t(j))
  assert trailing.shape == (40, 3, 3)
  assert torch.equal(svd3.from_trailing(trailing), _t(j))


def test_stratified_sampling():
  o = torch.zeros(32, 3)
  d = torch.nn.functional.normalize(torch.randn(32, 3), dim=-1)
  runs = [rendering.sample_along_rays(
      o, d, 64, 0.5, 3.0, False, torch.Generator().manual_seed(5))
          for _ in range(2)]
  z, points = runs[0]
  assert z.shape == (32, 64) and points.shape == (32, 64, 3)
  assert torch.equal(z, runs[1][0])  # same generator seed, same samples
  assert (z[:, 1:] >= z[:, :-1]).all()
  assert float(z.min()) >= 0.5 and float(z.max()) <= 3.0
  det, _ = rendering.sample_along_rays(o, d, 64, 0.5, 3.0, False)
  assert not torch.equal(z, det)
  # Each sample stays inside its stratum (between neighbouring midpoints).
  mids = 0.5 * (det[0, 1:] + det[0, :-1])
  assert (z[:, 1:] >= mids).all() and (z[:, :-1] <= mids).all()
  other, _ = rendering.sample_along_rays(o, d, 64, 0.5, 3.0, False,
                                         torch.Generator().manual_seed(6))
  assert not torch.equal(z, other)


def test_stratified_pdf_samples():
  rng = np.random.RandomState(10)
  z = np.sort(rng.uniform(0.5, 3.0, size=(8, 17)), axis=-1).astype(
      np.float32)
  weights = _t(rng.exponential(size=(8, 15))).requires_grad_(True)
  mids = _t(0.5 * (z[:, 1:] + z[:, :-1]))
  got = [rendering.piecewise_constant_pdf(mids, weights, 20,
                                          torch.Generator().manual_seed(1))
         for _ in range(2)]
  assert torch.equal(got[0], got[1]) and got[0].shape == (8, 20)
  assert not got[0].requires_grad  # the samples' gradient is stopped
  assert (got[0] >= mids[:, :1]).all() and (got[0] <= mids[:, -1:]).all()
  zs, points = rendering.sample_pdf(mids, weights, torch.zeros(8, 3),
                                    torch.ones(8, 3), _t(z), 20,
                                    torch.Generator().manual_seed(1))
  assert zs.shape == (8, 37) and (zs[:, 1:] >= zs[:, :-1]).all()


def test_noise_regularize_and_depth_index():
  sigma = torch.zeros(4, 8)
  gen = torch.Generator().manual_seed(0)
  assert torch.equal(rendering.noise_regularize(sigma, 0.5, False, gen),
                     sigma)
  assert torch.equal(rendering.noise_regularize(sigma, None, True, gen),
                     sigma)
  noisy = rendering.noise_regularize(sigma, 0.5, True, gen)
  assert not torch.equal(noisy, sigma) and torch.isfinite(noisy).all()
  rng = np.random.RandomState(11)
  weights = rng.uniform(size=(6, 12)).astype(np.float32) / 6.0
  weights[0] = 0.0
  want = jax_rendering.compute_depth_index(jnp.asarray(weights))
  got = rendering.compute_depth_index(_t(weights))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
