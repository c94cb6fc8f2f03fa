"""The port's random draws against JAX's and against their exact laws.

Every parity test samples deterministically or hands JAX's draws to the
port, so these tests hold the port's own draws to their distributions:
the stratified depths of sample_along_rays per stratum, the inverse-CDF
samples of piecewise_constant_pdf (fixed weights with zero-mass bins),
draw_background's warp ids and noise, and the independence of
consecutive steps' streams (training.step_generator). Each check runs
`nerfies_tpu_torch.draw_stats` at fixed seeds on at least 1e5 draws:
Kolmogorov-Smirnov (one sample against the exact law, two samples against
JAX's draws) below its critical value at 1e-3, chi-squared against
uniform below its 1e-3 quantile, and |r| < 4 / sqrt(n) between streams.
chip_smoke.py's draws phase runs the same checks on the card's Philox.
"""

import math
from unittest import mock

from jax import random
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu.ops import rendering as jax_rendering
from nerfies_tpu_torch import draw_stats
from nerfies_tpu_torch import training
from nerfies_tpu_torch.ops import rendering
from nerfies_tpu_torch.parallel import mesh
from tests.torch_threads import one_torch_thread  # pylint: disable=unused-import

NUM_RAYS = 131072
NUM_SAMPLES = 8
NUM_IDS = 24
CHECKS = ([f'stratified/{s}' for s in range(NUM_SAMPLES)]
          + ['pdf', 'background_ids', 'background_noise_mean',
             'background_noise_std', 'background_noise_ks']
          + [f'step_correlation/{seed}/{step}'
             for seed in draw_stats.STEP_SEEDS for step in draw_stats.STEPS])


@pytest.fixture(scope='module')
def port_checks():
  return draw_stats.check_draws('cpu', num_rays=NUM_RAYS,
                                num_samples=NUM_SAMPLES, num_ids=NUM_IDS)


@pytest.mark.parametrize('name', CHECKS)
def test_port_draws_follow_their_laws(port_checks, name):
  assert set(port_checks) == set(CHECKS)
  check = port_checks[name]
  assert check['n'] >= 1e5
  assert check['statistic'] < check['limit'], (name, check)


def _jax_depths(key):
  origins = jnp.zeros((NUM_RAYS, 3))
  directions = jnp.zeros((NUM_RAYS, 3)).at[:, 2].set(1.0)
  z_vals, _ = jax_rendering.sample_along_rays(
      key, origins, directions, NUM_SAMPLES, draw_stats.NEAR, draw_stats.FAR,
      True, False)
  return np.asarray(z_vals)


def test_stratified_depths_match_jax_per_stratum():
  got = draw_stats.stratified_depths(
      NUM_RAYS, NUM_SAMPLES, torch.Generator().manual_seed(1), 'cpu')
  want = _jax_depths(random.PRNGKey(1))
  lower, upper = draw_stats.stratum_edges(NUM_SAMPLES)
  limit = draw_stats.ks_critical(NUM_RAYS, NUM_RAYS)
  for s in range(NUM_SAMPLES):
    for z in (got[:, s], want[:, s]):
      assert z.min() >= np.float32(lower[s]) and z.max() <= np.float32(upper[s])
    assert draw_stats.ks_two_sample(got[:, s], want[:, s]) < limit, s


def _jax_pdf_samples(key, num_rays, num_samples):
  bins = jnp.broadcast_to(jnp.asarray(draw_stats.pdf_bins(), jnp.float32),
                          (num_rays, len(draw_stats.PDF_WEIGHTS) + 1))
  weights = jnp.broadcast_to(
      jnp.asarray(draw_stats.PDF_WEIGHTS, jnp.float32),
      (num_rays, len(draw_stats.PDF_WEIGHTS)))
  return np.asarray(jax_rendering.piecewise_constant_pdf(
      key, bins, weights, num_samples, True))


def test_pdf_samples_match_jax_and_the_exact_law():
  got = draw_stats.pdf_samples(1024, 128, torch.Generator().manual_seed(2),
                               'cpu')
  want = _jax_pdf_samples(random.PRNGKey(2), 1024, 128)
  n = got.size
  assert n >= 1e5
  assert draw_stats.ks_two_sample(got, want) < draw_stats.ks_critical(n, n)
  law = draw_stats.pdf_cdf(draw_stats.pdf_bins(), draw_stats.PDF_WEIGHTS)
  assert draw_stats.ks_one_sample(want, law) < draw_stats.ks_critical(n)
  # Zero-mass bins get (almost) no samples in either package.
  bins = draw_stats.pdf_bins()
  for i, w in enumerate(draw_stats.PDF_WEIGHTS):
    if w == 0.0:
      inside = lambda x: np.mean((x > bins[i] + 1e-4) & (x < bins[i + 1]))
      assert inside(got) == 0.0 and inside(want) == 0.0, i


def test_pdf_law_is_exact_on_the_deterministic_grid():
  """Without a generator the sampler maps a uniform grid of u's; the law's
  CDF maps each sample back to its u."""
  bins = torch.tensor(draw_stats.pdf_bins(), dtype=torch.float32)
  weights = torch.tensor(draw_stats.PDF_WEIGHTS, dtype=torch.float32)
  samples = rendering.piecewise_constant_pdf(bins[None], weights[None], 4097)
  law = draw_stats.pdf_cdf(draw_stats.pdf_bins(), draw_stats.PDF_WEIGHTS)
  np.testing.assert_allclose(law(samples[0].double().numpy()),
                             np.linspace(0.0, 1.0, 4097), atol=2e-6)


def test_background_draws_match_jax():
  ids, noise = draw_stats.background_draws(
      NUM_IDS, NUM_RAYS, torch.Generator().manual_seed(3), 'cpu')
  choice_key, noise_key = random.split(random.PRNGKey(3))
  jax_ids = np.asarray(random.choice(
      choice_key, jnp.arange(NUM_IDS, dtype=jnp.uint32),
      shape=(NUM_RAYS, 1))).ravel()
  jax_noise = np.asarray(random.normal(noise_key, (NUM_RAYS, 3)))
  for drawn in (ids, jax_ids):
    statistic, limit = draw_stats.chi2_uniform(drawn, NUM_IDS)
    assert statistic < limit
  for name, check in draw_stats.noise_checks(jax_noise).items():
    assert check['statistic'] < check['limit'], name
  assert (draw_stats.ks_two_sample(noise, jax_noise)
          < draw_stats.ks_critical(noise.size, jax_noise.size))


def test_consecutive_steps_are_as_independent_as_jax_fold_in():
  """The port's step k and k + 1 streams, and JAX's fold_in(key, k) and
  fold_in(key, k + 1), each below 4 / sqrt(n); so are two seeds' streams
  at one step."""
  limit = 4.0 / math.sqrt(NUM_RAYS)
  for seed in draw_stats.STEP_SEEDS:
    key = random.PRNGKey(seed)
    for step in draw_stats.STEPS:
      port = [torch.rand(NUM_RAYS, generator=training.step_generator(
          seed, k, 'cpu')).numpy() for k in (step, step + 1, step)]
      jax_draws = [np.asarray(random.uniform(random.fold_in(key, k),
                                             (NUM_RAYS,)))
                   for k in (step, step + 1)]
      assert draw_stats.correlation(port[0], port[1]) < limit
      assert draw_stats.correlation(*jax_draws) < limit
      assert np.array_equal(port[0], port[2])  # a step's stream repeats
      other = torch.rand(NUM_RAYS, generator=training.step_generator(
          seed + 2, step, 'cpu')).numpy()
      assert draw_stats.correlation(port[0], other) < limit


def test_checks_catch_a_biased_jitter():
  """A jitter drawn as u ** 1.05 in place of u fails the strata's KS."""
  def biased(fn, shape, generator, **kwargs):
    return fn(shape, generator=generator, **kwargs) ** 1.05

  with mock.patch.object(mesh, 'draw', biased):
    z = draw_stats.stratified_depths(NUM_RAYS, 2,
                                     torch.Generator().manual_seed(4), 'cpu')
  lower, upper = draw_stats.stratum_edges(2)
  uniform = lambda x: np.clip((x - lower[0]) / (upper[0] - lower[0]), 0, 1)
  assert (draw_stats.ks_one_sample(z[:, 0], uniform)
          > draw_stats.ks_critical(NUM_RAYS))
