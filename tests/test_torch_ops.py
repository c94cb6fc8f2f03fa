"""The port's tensor ops against the JAX package's, in float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu.ops import encoding as jax_encoding
from nerfies_tpu.ops import rendering as jax_rendering
from nerfies_tpu.ops import rigid as jax_rigid
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import rendering
from nerfies_tpu_torch.ops import rigid

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
