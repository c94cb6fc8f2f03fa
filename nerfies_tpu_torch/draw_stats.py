"""Statistics of the training step's random draws against their exact
distributions.

The step draws from one generator a step (`training.step_generator`):
the stratified jitter of `rendering.sample_along_rays`, the inverse-CDF
u's of `rendering.piecewise_constant_pdf` and the background loss's
warp ids and noise (`training.draw_background`). No parity test can hold
those draws to JAX's value for value, so `check_draws` holds their
distributions to the exact ones, with the statistic of each check beside
its critical value at ALPHA:

  stratified/<s>  one-sample Kolmogorov-Smirnov of stratum s's depths
                  against the uniform law between its edges;
  pdf             one-sample KS of the inverse-CDF samples of fixed
                  weights with zero-mass bins against the exact law of
                  piecewise_constant_pdf (a bin of mass below its eps puts
                  its samples within mass x width of its left edge);
  background_ids  chi-squared of the warp ids against uniform;
  background_noise_mean / _std / _ks  the noise's mean and standard
                  deviation (z scores) and KS against the standard normal;
  step_correlation/<seed>/<step>  |Pearson r| of the first uniforms of
                  step k's and step k + 1's streams, limit 4 / sqrt(n).

tests/test_torch_draws.py runs it on the CPU (mt19937) beside JAX's draws;
chip_smoke.py's draws phase runs it on the card (Philox). Runs on the
card unless told device='cpu'.
"""

import math
import types
from typing import Callable, Dict

import numpy as np
from scipy import special
from scipy import stats as scipy_stats
import torch

from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch import training
from nerfies_tpu_torch.ops import rendering

ALPHA = 1e-3
# Fixed non-uniform bin masses with zero-mass bins, over 16 bins.
PDF_WEIGHTS = (0.0, 0.0, 0.5, 2.0, 0.0, 1.0, 3.0, 0.0,
               0.1, 0.7, 0.0, 0.0, 1.5, 0.2, 0.0, 0.4)
PDF_EPS = 1e-5
NEAR, FAR = 0.5, 4.0
# The quality bench's step seeds (2s + 1) and steps across its run.
STEP_SEEDS = (1, 3, 5, 7)
STEPS = (1, 1667, 2999)


def ks_critical(n: int, m: int = 0, alpha: float = ALPHA) -> float:
  """The asymptotic Kolmogorov-Smirnov critical value at `alpha`: one
  sample of n, or two samples of n and m."""
  c = math.sqrt(-0.5 * math.log(alpha / 2))
  return c * math.sqrt((n + m) / (n * m)) if m else c / math.sqrt(n)


def ks_one_sample(samples, cdf: Callable) -> float:
  """sup |empirical CDF - cdf| over the samples."""
  x = np.sort(np.asarray(samples, np.float64).ravel())
  f = cdf(x)
  n = len(x)
  return float(max(np.max(np.arange(1, n + 1) / n - f),
                   np.max(f - np.arange(n) / n)))


def ks_two_sample(a, b) -> float:
  """sup |CDF_a - CDF_b| over both samples."""
  a = np.sort(np.asarray(a, np.float64).ravel())
  b = np.sort(np.asarray(b, np.float64).ravel())
  both = np.concatenate([a, b])
  return float(np.max(np.abs(np.searchsorted(a, both, 'right') / len(a)
                             - np.searchsorted(b, both, 'right') / len(b))))


def stratum_edges(num_samples: int, near: float = NEAR, far: float = FAR):
  """Each stratum's (lower, upper) depths in sample_along_rays (linear in
  depth), in float64."""
  t = np.linspace(0.0, 1.0, num_samples)
  z = near * (1.0 - t) + far * t
  mids = 0.5 * (z[1:] + z[:-1])
  return np.concatenate([z[:1], mids]), np.concatenate([mids, z[-1:]])


def pdf_bins(num_bins: int = len(PDF_WEIGHTS)) -> np.ndarray:
  return np.linspace(NEAR, FAR, num_bins + 1)


def pdf_cdf(bins, weights, eps: float = PDF_EPS) -> Callable:
  """The exact CDF of piecewise_constant_pdf's samples for one ray's bins
  and weights: u uniform, bin i holds u in [c_i, c_i+1) and maps it to
  b_i + (u - c_i) / d_i x (b_i+1 - b_i), where d_i is the bin's mass, or
  1 for a mass below eps."""
  bins = np.asarray(bins, np.float64)
  mass = np.asarray(weights, np.float64) + eps
  edges = np.concatenate([[0.0], np.cumsum(mass) / mass.sum()])
  span = np.diff(edges)
  denom = np.where(span < eps, 1.0, span)
  width = np.diff(bins)

  def cdf(z):
    i = np.clip(np.searchsorted(bins, z, 'right') - 1, 0, len(width) - 1)
    u = edges[i] + (z - bins[i]) * denom[i] / width[i]
    return np.clip(np.minimum(u, edges[i + 1]), 0.0, 1.0)

  return cdf


def stratified_depths(num_rays: int, num_samples: int, generator,
                      device) -> np.ndarray:
  """(num_rays, num_samples) depths of sample_along_rays."""
  origins = torch.zeros(num_rays, 3, device=device)
  directions = torch.zeros(num_rays, 3, device=device)
  directions[:, 2] = 1.0
  z_vals, _ = rendering.sample_along_rays(
      origins, directions, num_samples, NEAR, FAR, False, generator)
  return z_vals.cpu().numpy()


def pdf_samples(num_rays: int, num_samples: int, generator,
                device) -> np.ndarray:
  """(num_rays, num_samples) samples of piecewise_constant_pdf for
  PDF_WEIGHTS over pdf_bins() on every ray."""
  bins = torch.tensor(pdf_bins(), dtype=torch.float32, device=device)
  weights = torch.tensor(PDF_WEIGHTS, dtype=torch.float32, device=device)
  return rendering.piecewise_constant_pdf(
      bins.expand(num_rays, -1), weights.expand(num_rays, -1), num_samples,
      generator).cpu().numpy()


def background_draws(num_ids: int, num_points: int, generator, device):
  """draw_background's (P,) warp ids and (P, 3) noise for warp ids
  0..num_ids-1."""
  model = types.SimpleNamespace(warp_ids=tuple(range(num_ids)))
  ids, noise = training.draw_background(model, num_points, generator, device)
  return ids.cpu().numpy().ravel(), noise.cpu().numpy()


def chi2_uniform(ids, num_ids: int):
  """(chi-squared statistic, its critical value at ALPHA) of ids against
  the uniform law over num_ids values."""
  counts = np.bincount(np.asarray(ids).ravel(), minlength=num_ids)
  if len(counts) != num_ids:
    return math.inf, 0.0
  expected = counts.sum() / num_ids
  statistic = float(((counts - expected) ** 2 / expected).sum())
  return statistic, float(scipy_stats.chi2.ppf(1.0 - ALPHA, num_ids - 1))


def correlation(a, b) -> float:
  return float(abs(np.corrcoef(np.asarray(a, np.float64).ravel(),
                               np.asarray(b, np.float64).ravel())[0, 1]))


def noise_checks(noise) -> Dict[str, Dict[str, float]]:
  """The noise's mean and std as z scores, and KS against N(0, 1)."""
  x = np.asarray(noise, np.float64).ravel()
  n = len(x)
  z = float(special.ndtri(1.0 - ALPHA / 2))
  return {
      'background_noise_mean': {
          'statistic': abs(float(x.mean())) * math.sqrt(n), 'limit': z},
      # The sample variance of n normals has sd sqrt(2 / n).
      'background_noise_std': {
          'statistic': abs(float(x.var()) - 1.0) / math.sqrt(2.0 / n),
          'limit': z},
      'background_noise_ks': {
          'statistic': ks_one_sample(x, special.ndtr),
          'limit': ks_critical(n)},
  }


def check_draws(device='cuda', num_rays: int = 131072,
                num_samples: int = 8, num_ids: int = 24,
                seed: int = 0) -> Dict[str, Dict[str, float]]:
  """Every check of the module's docstring on `device`, each as
  {'statistic': x, 'limit': y, 'n': draws}; a check passes where
  statistic < limit."""
  device = resolve_device(device)
  generator = torch.Generator(device).manual_seed(seed)
  out = {}
  z = stratified_depths(num_rays, num_samples, generator, device)
  lower, upper = stratum_edges(num_samples)
  for s in range(num_samples):
    cdf = lambda x, lo=lower[s], hi=upper[s]: np.clip(
        (x - lo) / (hi - lo), 0.0, 1.0)
    out[f'stratified/{s}'] = {'statistic': ks_one_sample(z[:, s], cdf),
                              'limit': ks_critical(num_rays), 'n': num_rays}
  samples = pdf_samples(num_rays // 128, 128, generator, device)
  out['pdf'] = {'statistic': ks_one_sample(samples,
                                           pdf_cdf(pdf_bins(), PDF_WEIGHTS)),
                'limit': ks_critical(samples.size), 'n': samples.size}
  ids, noise = background_draws(num_ids, num_rays, generator, device)
  statistic, limit = chi2_uniform(ids, num_ids)
  out['background_ids'] = {'statistic': statistic, 'limit': limit,
                           'n': ids.size}
  for name, entry in noise_checks(noise).items():
    out[name] = dict(entry, n=noise.size)
  for step_seed in STEP_SEEDS:
    for step in STEPS:
      first, second = (torch.rand(
          num_rays, generator=training.step_generator(step_seed, k, device),
          device=device).cpu().numpy() for k in (step, step + 1))
      out[f'step_correlation/{step_seed}/{step}'] = {
          'statistic': correlation(first, second),
          'limit': 4.0 / math.sqrt(num_rays), 'n': num_rays}
  return out


def failures(checks: Dict[str, Dict[str, float]]):
  """The names of the checks whose statistic reaches its limit."""
  return [name for name, c in checks.items()
          if not c['statistic'] < c['limit']]
