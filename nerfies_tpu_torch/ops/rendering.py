"""Volumetric rendering math: ray sampling, compositing, depth maps.

Port of nerfies_tpu/ops/rendering.py. The random draws (stratified jitter,
inverse-CDF samples, density noise) take an explicit torch.Generator on
the tensors' device in place of a JAX key: given one, the sampler jitters;
given none, it samples deterministically. The two frameworks' streams
differ, so tests compare the deterministic paths and the statistics of
the random ones. The reference locates the inverse-CDF bin with a one-hot
matmul, a TPU rewrite; here `torch.searchsorted` and `torch.gather` do
it, with the same results. Under data parallelism the generator is a
`parallel.mesh.RankRows` stream: each draw is made at the global rows
and cut to this rank's (`mesh.draw`).
"""

from typing import Optional

import torch

from nerfies_tpu_torch.parallel import mesh


def sample_along_rays(origins: torch.Tensor, directions: torch.Tensor,
                      num_samples: int, near: float, far: float,
                      use_linear_disparity: bool,
                      generator: Optional[torch.Generator] = None):
  """Depth samples along rays, stratified when given a generator.

  Args:
    origins: (B, 3) ray origins.
    directions: (B, 3) ray directions.
    num_samples: samples per ray S.
    near / far: clip range.
    use_linear_disparity: sample linearly in 1/z instead of z.
    generator: draws one uniform jitter per sample inside its stratum
      (between the midpoints of its neighbours); None samples the strata
      edges deterministically.

  Returns:
    z_vals (B, S) and points (B, S, 3).
  """
  t_vals = torch.linspace(0.0, 1.0, num_samples, dtype=origins.dtype,
                          device=origins.device)
  if not use_linear_disparity:
    z_vals = near * (1.0 - t_vals) + far * t_vals
  else:
    z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
  if generator is not None:
    mids = 0.5 * (z_vals[1:] + z_vals[:-1])
    upper = torch.cat([mids, z_vals[-1:]])
    lower = torch.cat([z_vals[:1], mids])
    t_rand = mesh.draw(torch.rand, (origins.shape[0], num_samples),
                       generator, dtype=origins.dtype, device=origins.device)
    z_vals = lower + (upper - lower) * t_rand
  else:
    z_vals = z_vals[None, :].expand(origins.shape[0], num_samples)
  points = origins[..., None, :] + z_vals[..., :, None] * directions[..., None, :]
  return z_vals, points


def ladder_dists(z_vals: torch.Tensor,
                 sample_at_infinity: bool) -> torch.Tensor:
  """Per-sample depth spacings of a sorted ladder (before |dirs| scaling)."""
  last = 1e10 if sample_at_infinity else 1e-19
  return torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                    torch.full_like(z_vals[..., :1], last)], dim=-1)


def volumetric_rendering(rgb: torch.Tensor,
                         sigma: torch.Tensor,
                         z_vals: torch.Tensor,
                         dirs: torch.Tensor,
                         use_white_background: bool,
                         sample_at_infinity: bool = True,
                         return_weights: bool = False,
                         eps: float = 1e-10,
                         dists: Optional[torch.Tensor] = None):
  """Alpha compositing of per-sample radiance and density into pixels.

  Args:
    rgb: (B, S, 3) colours; sigma: (B, S) densities; z_vals: (B, S)
    depths; dirs: (B, 3) ray directions (not necessarily unit norm).
    dists: optional (B, S) spacings overriding the ladder's own.

  Returns:
    dict with 'rgb' (B, 3), 'depth' (B,), 'med_depth' (B,), 'acc' (B,)
    [, 'weights' (B, S)].
  """
  if dists is None:
    dists = ladder_dists(z_vals, sample_at_infinity)
  dists = dists * torch.linalg.norm(dirs, dim=-1, keepdim=True)
  alpha = 1.0 - torch.exp(-sigma * dists)
  trans = torch.cat([torch.ones_like(alpha[..., :1]),
                     torch.cumprod(1.0 - alpha[..., :-1] + eps, dim=-1)],
                    dim=-1)
  weights = alpha * trans
  out_rgb = (weights[..., None] * rgb).sum(dim=-2)
  exp_depth = (weights * z_vals).sum(dim=-1)
  med_depth = compute_depth_map(weights, z_vals)
  acc = weights.sum(dim=-1)
  if use_white_background:
    out_rgb = out_rgb + (1.0 - acc[..., None])
  if sample_at_infinity:
    acc = weights[..., :-1].sum(dim=-1)
  out = {'rgb': out_rgb, 'depth': exp_depth, 'med_depth': med_depth,
         'acc': acc}
  if return_weights:
    out['weights'] = weights
  return out


def piecewise_constant_pdf(bins: torch.Tensor, weights: torch.Tensor,
                           num_samples: int,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
  """Inverse-CDF sampling from a piecewise-constant density.

  Args:
    bins: (B, n_bins + 1) sorted bin edges.
    weights: (B, n_bins) unnormalised bin masses.
    num_samples: number of new samples.
    generator: draws the u's uniformly; None takes a uniform grid.

  Returns:
    (B, num_samples) sampled depths, detached from the graph (the JAX
    version stops their gradient).
  """
  bins, weights = bins.detach(), weights.detach()
  eps = 1e-5
  num_bins = weights.shape[-1]
  cdf = torch.cumsum(weights + eps, dim=-1)
  cdf = cdf / cdf[..., -1:]
  cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1).contiguous()
  if generator is not None:
    u = mesh.draw(torch.rand, (cdf.shape[0], num_samples), generator,
                  dtype=cdf.dtype, device=cdf.device)
  else:
    u = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype,
                       device=cdf.device).expand(cdf.shape[0], num_samples)
  # Index of the last edge with cdf <= u, clamped into the bin range.
  num_le = torch.searchsorted(cdf, u.contiguous(), right=True)
  bin_idx = torch.clamp(num_le - 1, 0, num_bins - 1)
  lo = torch.gather(cdf, -1, bin_idx)
  hi = torch.gather(cdf, -1, bin_idx + 1)
  edge_lo = torch.gather(bins, -1, bin_idx)
  edge_hi = torch.gather(bins, -1, bin_idx + 1)
  # Zero-mass bins interpolate with the denominator snapped to 1.
  span = hi - lo
  t = (u - lo) / torch.where(span < eps, torch.ones_like(span), span)
  return edge_lo + t * (edge_hi - edge_lo)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               origins: torch.Tensor, directions: torch.Tensor,
               z_vals: torch.Tensor, num_samples: int,
               generator: Optional[torch.Generator] = None):
  """Hierarchical resampling: sorted union of coarse z's and PDF samples.

  Returns:
    z_vals (B, S_coarse + num_samples) and points (B, ..., 3).
  """
  z_samples = piecewise_constant_pdf(bins, weights, num_samples, generator)
  z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
  points = origins[..., None, :] + z_vals[..., None] * directions[..., None, :]
  return z_vals, points


def compute_opaqueness_mask(weights: torch.Tensor,
                            depth_threshold: float = 0.5) -> torch.Tensor:
  """One-hot mask of the sample where cumulative weight crosses the threshold."""
  opaqueness = torch.cumsum(weights, dim=-1) >= depth_threshold
  padded = torch.cat([torch.zeros_like(opaqueness[..., :1]),
                      opaqueness[..., :-1]], dim=-1)
  return torch.logical_xor(opaqueness, padded).to(weights.dtype)


def compute_depth_index(weights: torch.Tensor,
                        depth_threshold: float = 0.5) -> torch.Tensor:
  """Sample index of the median-depth termination point (first maximum)."""
  return torch.argmax(compute_opaqueness_mask(weights, depth_threshold),
                      dim=-1)


def noise_regularize(raw_sigma: torch.Tensor, noise_std: Optional[float],
                     use_stratified_sampling: bool,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
  """Adds N(0, noise_std^2) to raw densities when training stratified."""
  if noise_std is not None and noise_std > 0.0 and use_stratified_sampling:
    noise = mesh.draw(torch.randn, raw_sigma.shape, generator,
                      dtype=raw_sigma.dtype, device=raw_sigma.device)
    raw_sigma = raw_sigma + noise * noise_std
  return raw_sigma


def compute_depth_map(weights: torch.Tensor, z_vals: torch.Tensor,
                      depth_threshold: float = 0.5) -> torch.Tensor:
  """Median-accumulation depth."""
  mask = compute_opaqueness_mask(weights, depth_threshold)
  return torch.sum(mask * z_vals, dim=-1)
