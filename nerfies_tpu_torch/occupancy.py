"""Occupancy-grid empty-space skipping for the serving render path.

Port of nerfies_tpu/occupancy.py. The scene's density is baked into a
dense boolean voxel grid over the canonical frame (sample points are
queried after the warp, so one grid serves every frame of a dynamic
capture). At render time each ray still proposes its full ladder of S
candidates, and only a fixed number K of them, the first K occupied in
depth order, reach the NeRF MLP: a stable sort on the occupancy bit, so
every launch keeps one shape. Kept samples composite with their original
ladder spacing (`rendering.ladder_dists` gathered by `gather_samples`),
and the last sample, the background shell, is always kept; the grid is
dilated by one voxel to stay conservative at surfaces.

The bake evaluates the NeRF MLP at the voxel centres through
`ops/fused_mlp.nerf_mlp_forward` without an rgb row bias: the kernel on a
CUDA tensor, its plain version on a CPU tensor.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import fused_mlp


@dataclasses.dataclass
class OccupancyGrid:
  """Boolean voxel grid over an axis-aligned box in canonical space.

  Attributes:
    occupied: (R, R, R) bool, True where the baked density exceeded the
      build threshold (after one step of 3^3 max-pool dilation).
    bbox_min: (3,) f32 lower corner.
    bbox_max: (3,) f32 upper corner.
  """
  occupied: torch.Tensor
  bbox_min: torch.Tensor
  bbox_max: torch.Tensor

  @property
  def resolution(self) -> int:
    return self.occupied.shape[0]

  def query(self, points: torch.Tensor) -> torch.Tensor:
    """(..., 3) points -> (...) bool occupancy.

    Points outside the box clamp to the boundary voxel: the box should
    cover the whole visible domain, and clamping errs on what the
    boundary voxel says rather than culling geometry a too-small box
    pushed outside.
    """
    r = self.resolution
    scale = r / (self.bbox_max - self.bbox_min)
    idx = torch.clamp(((points - self.bbox_min) * scale).to(torch.int32),
                      0, r - 1).long()
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]
    return self.occupied.reshape(-1)[flat]


def build_grid(sigma_fn: Callable[[torch.Tensor], torch.Tensor],
               bbox_min,
               bbox_max,
               resolution: int = 128,
               sigma_threshold: float = 0.01,
               dilate: bool = True,
               chunk: int = 262144,
               device='cuda') -> OccupancyGrid:
  """Bakes a density field into an OccupancyGrid on `device`.

  Args:
    sigma_fn: (N, 3) canonical points -> (N,) post-activation densities,
      e.g. `sigma_fn_from_params`. Evaluated at voxel centres in chunks.
    bbox_min / bbox_max: canonical-space box to bake; must cover every
      point the render can produce.
    resolution: voxels per axis (R^3 queries).
    sigma_threshold: voxels with sigma <= threshold are empty.
    dilate: one step of 3^3 max-pool, so that surfaces straddling a voxel
      boundary keep their neighbours (conservative culling).
    chunk: grid points per sigma_fn call.
    device: where the voxel centres, the densities and the grid live.
  """
  device = resolve_device(device)
  r = resolution
  bbox_min = np.asarray(bbox_min, np.float32)
  bbox_max = np.asarray(bbox_max, np.float32)
  cell = (bbox_max - bbox_min) / r
  axes = [np.arange(r, dtype=np.float32) + 0.5 for _ in range(3)]
  grid = np.stack(np.meshgrid(*axes, indexing='ij'), axis=-1)  # (R,R,R,3)
  centers = torch.from_numpy(grid.reshape(-1, 3) * cell + bbox_min).to(device)

  sigma = torch.cat([sigma_fn(centers[lo:lo + chunk]).reshape(-1)
                     for lo in range(0, centers.shape[0], chunk)])
  occupied = (sigma > sigma_threshold).reshape(r, r, r)
  if dilate:
    occupied = F.max_pool3d(occupied[None, None].float(), kernel_size=3,
                            stride=1, padding=1)[0, 0] > 0
  return OccupancyGrid(occupied=occupied,
                       bbox_min=torch.from_numpy(bbox_min).to(device),
                       bbox_max=torch.from_numpy(bbox_max).to(device))


def sigma_fn_from_params(params, model, level: str = 'fine'):
  """Density query of a trained NerfModel at raw canonical points.

  Runs the NeRF MLP of `level` through `fused_mlp.nerf_mlp_forward` with
  no rgb row bias. Conditions do not affect sigma unless the model has an
  alpha condition, in which case the appearance code of id 0 is used
  (appearance modulates shading far more than geometry).
  """
  mlp_params = params[f'nerf_mlps_{level}']
  width = mlp_params['trunk_hidden_0']['kernel'].shape[1]

  @torch.no_grad()
  def sigma_fn(points: torch.Tensor) -> torch.Tensor:
    pe = encoding.posenc(points[:, None, :],
                         num_freqs=model.num_nerf_point_freqs)
    alpha, _ = fused_mlp.nerf_mlp_forward(
        pe.reshape(points.shape[0], -1).to(torch.bfloat16), None,
        mlp_params, trunk_depth=model.nerf_trunk_depth,
        skips=tuple(model.nerf_skips))
    raw_sigma = alpha[:, 0]
    if model.use_alpha_condition and 'appearance_encoder' in params:
      code = params['appearance_encoder']['embed']['embedding'][:1]
      alpha_k = mlp_params['alpha_logit']['kernel']
      raw_sigma = raw_sigma + (
          code.to(torch.bfloat16)
          @ alpha_k[width:].to(torch.bfloat16)).float()[0, 0]
    return model.sigma_activation_fn(raw_sigma)

  return sigma_fn


def select_occupied(occ: torch.Tensor,
                    k: int,
                    keep_last: bool = True) -> torch.Tensor:
  """Indices of the first k occupied samples per ray, in depth order.

  Args:
    occ: (B, S) bool occupancy of each candidate, candidates in depth
      order (as sample_along_rays and sample_pdf emit them).
    k: number of samples to keep.
    keep_last: always keep index S-1 (the sample-at-infinity background
      shell, which compositing treats specially) and pick the first k-1
      occupied among the rest.

  Returns:
    (B, min(k, S)) int64 indices into the sample axis, ascending. Rays
    with fewer than k occupied samples pad with their leading empty
    candidates (their density is below the threshold by construction).
  """
  s = occ.shape[-1]
  if k >= s:
    return torch.arange(s, device=occ.device).expand(occ.shape)
  # A stable sort on the negated occupancy bit: occupied candidates come
  # first, and ties keep depth order.
  if keep_last:
    order = torch.argsort(-occ[..., :-1].int(), dim=-1, stable=True)
    last = torch.full(occ.shape[:-1] + (1,), s - 1, dtype=order.dtype,
                      device=occ.device)
    return torch.sort(torch.cat([order[..., :k - 1], last], dim=-1),
                      dim=-1).values
  order = torch.argsort(-occ.int(), dim=-1, stable=True)
  return torch.sort(order[..., :k], dim=-1).values


def gather_samples(z_vals: torch.Tensor, points: torch.Tensor,
                   idx: torch.Tensor,
                   dists: Optional[torch.Tensor] = None):
  """Gathers (B, S) z_vals / (B, S, 3) points [/ (B, S) dists] to (B, K).

  `dists` should be the full ladder's spacings (rendering.ladder_dists):
  kept samples composite with their original spacing, not the distance
  to the next kept sample, so that the culled render matches the full one
  wherever the dropped densities are ~0.
  """
  z_k = torch.gather(z_vals, -1, idx)
  pts_k = torch.gather(points, -2, idx[..., None].expand(*idx.shape, 3))
  if dists is None:
    return z_k, pts_k
  return z_k, pts_k, torch.gather(dists, -1, idx)
