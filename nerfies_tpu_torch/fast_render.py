"""The serving renderer: a lean forward over the param tree.

Port of nerfies_tpu/fast_render.py:41-277. Sampling, the warp, the
encodings and compositing are plain PyTorch; the two MLP stacks go
through ops/fused_mlp.py, which on a CUDA tensor launches the
hand-written kernels (csrc/fused_mlp.cu) and on a CPU tensor runs their
plain versions.

There is no `mlp=` switch. The JAX default, mlp='xla', was chosen from a
TPU timing (XLA's per-layer pipeline beat the Pallas forward at render on
v5e), which says nothing about this card; the port serves through the
kernels. Deterministic rendering only, as in the JAX path. With an
occupancy grid (`occupancy.py`) and `keep_samples`, each level runs the
NeRF MLP on only the first K occupied candidates of each ray.
"""

from typing import Any, Dict, Optional, Tuple

import torch

from nerfies_tpu_torch import occupancy as occupancy_lib
from nerfies_tpu_torch.models import glo
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import rendering
from nerfies_tpu_torch.ops import rigid


def supported(model) -> bool:
  """Whether the fused render path covers this model architecture.

  `model` is a NerfModel or a ModelConfig (which has no encoded metadata).
  """
  if model.use_trunk_condition:
    return False
  if getattr(model, 'metadata_encoded', False):
    return False
  if model.use_warp and model.warp_metadata_encoder_type != 'glo':
    return False
  if model.use_warp and model.warp_field_type not in ('se3', 'translation'):
    return False
  if model.use_warp:
    kwargs = dict(model.warp_kwargs)
    if kwargs.get('use_pivot') or kwargs.get('use_translation'):
      return False
  return True


def _glo_lookup(encoder_params, ids: torch.Tensor) -> torch.Tensor:
  """(B, 1) integer ids -> (B, F) codes, straight from the table."""
  return glo.lookup(encoder_params, ids)


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """A small per-ray product in bf16, as the JAX path computes it."""
  return a.to(torch.bfloat16) @ b.to(torch.bfloat16)


def _apply_warp_fused(params, model, points, warp_ids, warp_extra):
  """SE(3) or translation warp of (B, S, 3) points via the fused trunk."""
  warp_params = params['warp_field']
  b, s = points.shape[:2]
  kwargs = dict(model.warp_kwargs)
  skips = tuple(kwargs.get('skips', (4,)))
  # SE3Field names its depth 'trunk_depth'; TranslationField uses 'depth'.
  if model.warp_field_type == 'translation':
    trunk_depth = int(kwargs.get('depth', 6))
  else:
    trunk_depth = int(kwargs.get('trunk_depth', 6))

  # The encoding's kwargs as the warp field reads them (models/warping.py),
  # as the training warp passes them (fused_train.apply_warp).
  pe = encoding.posenc(points, num_freqs=model.num_warp_freqs,
                       min_freq_log2=kwargs.get('min_freq_log2', 0.0),
                       max_freq_log2=kwargs.get('max_freq_log2'),
                       use_identity=kwargs.get('use_identity_map', True),
                       alpha=warp_extra.get('alpha'))
  c_pe = pe.shape[-1]
  embed = _glo_lookup(warp_params['metadata_encoder'], warp_ids)  # (B, F)

  if model.warp_field_type == 'translation':
    mlp_tree = warp_params['mlp']
    trunk = {k: v for k, v in mlp_tree.items() if k.startswith('hidden')}
    head = mlp_tree['logit']
  else:
    trunk = warp_params['trunk']
    if 'branches_wv' in warp_params:
      head = warp_params['branches_wv']['logit']
    else:
      w_l = warp_params['branches_w']['logit']
      v_l = warp_params['branches_v']['logit']
      head = {'kernel': torch.cat([w_l['kernel'], v_l['kernel']], -1),
              'bias': torch.cat([w_l['bias'], v_l['bias']], -1)}

  # The embedding's rows of layer 0 and of each skip layer enter as
  # per-row biases: one product per ray, repeated over its S samples
  # (the same values as the JAX path's product per row).
  width = trunk['hidden_0']['kernel'].shape[1]
  blocks = [(0, trunk['hidden_0']['kernel'][c_pe:])]
  blocks += [(i, trunk[f'hidden_{i}']['kernel'][width + c_pe:])
             for i in skips if i < trunk_depth]
  row_biases = [(i, torch.repeat_interleave(_bf16_matmul(embed, k), s, dim=0))
                for i, k in blocks]

  out = fused_mlp.warp_trunk_forward(
      pe.reshape(b * s, c_pe), row_biases,
      {'trunk': trunk, 'head': {'logit': head}},
      trunk_depth=trunk_depth, skips=skips, head_key='head')
  if model.warp_field_type == 'translation':
    return points + out[:, :3].reshape(b, s, 3).to(points.dtype)
  w = out[:, :3].reshape(b, s, 3)
  v = out[:, 3:6].reshape(b, s, 3)
  return rigid.se3_apply_raw(w, v, points.float())


def _render_level(params, model, level, points, z_vals, directions,
                  viewdirs, metadata, warp_extra, use_warp, occupancy=None,
                  keep=None):
  if use_warp:
    points = _apply_warp_fused(params, model, points, metadata['warp'],
                               warp_extra)
  culled = occupancy is not None and keep is not None
  dists = None
  if culled:
    # Empty-space skipping: of the S depth-ordered candidates only the
    # first `keep` whose canonical (post-warp) position lies in an
    # occupied voxel reach the MLP; they keep their ladder spacing.
    idx = occupancy_lib.select_occupied(occupancy.query(points), keep)
    z_vals, points, dists = occupancy_lib.gather_samples(
        z_vals, points, idx,
        rendering.ladder_dists(z_vals, model.use_sample_at_infinity))
  b, s = points.shape[:2]
  pe = encoding.posenc(points, num_freqs=model.num_nerf_point_freqs)
  c_pe = pe.shape[-1]
  _, alpha_condition, rgb_condition = model.get_condition_inputs(
      params, viewdirs, metadata)
  mlp_params = params[f'nerf_mlps_{level}']
  width = mlp_params['trunk_hidden_0']['kernel'].shape[1]
  rgb_row_bias = None
  if rgb_condition is not None:
    rgb_k = mlp_params['rgb_hidden_0']['kernel']
    rgb_row_bias = torch.repeat_interleave(
        _bf16_matmul(rgb_condition, rgb_k[width:]), s, dim=0)
  alpha, rgb_raw = fused_mlp.nerf_mlp_forward(
      pe.reshape(b * s, c_pe), rgb_row_bias, mlp_params,
      trunk_depth=model.nerf_trunk_depth, skips=tuple(model.nerf_skips))
  raw_sigma = alpha[:, 0].reshape(b, s)
  if alpha_condition is not None:
    alpha_k = mlp_params['alpha_logit']['kernel']
    raw_sigma = raw_sigma + _bf16_matmul(alpha_condition,
                                         alpha_k[width:]).float()
  rgb = torch.sigmoid(rgb_raw[:, :3].reshape(b, s, 3))
  if model.rgb_padding:
    rgb = rgb * (1.0 + 2.0 * model.rgb_padding) - model.rgb_padding
  sigma = model.sigma_activation_fn(raw_sigma)
  out = rendering.volumetric_rendering(
      rgb, sigma, z_vals, directions,
      use_white_background=model.use_white_background,
      sample_at_infinity=model.use_sample_at_infinity,
      return_weights=True, dists=dists)
  if culled:
    # The kept depth ladder, for the fine level's PDF resampling.
    out['kept_z_vals'] = z_vals
  return out


@torch.no_grad()
def render_rays(params: Dict[str, Any],
                rays_dict: Dict[str, Any],
                warp_extra: Dict[str, Any],
                model,
                use_warp: bool = True,
                return_weights: bool = False,
                occupancy=None,
                keep_samples: Optional[Tuple[int, int]] = None
                ) -> Dict[str, Any]:
  """Deterministic coarse (+ fine) render of a flat ray batch.

  Args:
    params: the model's param tree, on the rays' device.
    rays_dict: {'origins' (B, 3), 'directions' (B, 3), 'viewdirs'?,
      'metadata': {'warp' / 'appearance' / 'camera': (B, 1) int ids}}.
    warp_extra: {'alpha': warp annealing progress, ...}.
    model: a NerfModel (the static architecture).
    use_warp: apply the warp field if the model has one.
    return_weights: keep the compositing weights in the output.
    occupancy: an occupancy.OccupancyGrid baked from this model's density.
    keep_samples: (k_coarse, k_fine) with `occupancy`: each level runs the
      MLP on the first k occupied candidates of each ray; None for either
      leaves that level unculled. Exact up to the grid's threshold.

  Returns:
    {'coarse': {...}, 'fine'?: {...}} with rgb / depth / med_depth / acc
    (+ weights) per level, as the JAX `render_rays` returns.
  """
  if model.use_stratified_sampling:
    raise NotImplementedError('serving renders deterministically; the '
                              'model uses stratified sampling')
  use_warp = use_warp and model.use_warp
  origins = rays_dict['origins']
  directions = rays_dict['directions']
  metadata = rays_dict['metadata']
  viewdirs = rays_dict.get('viewdirs', directions)

  keep_coarse, keep_fine = keep_samples or (None, None)
  z_vals, points = rendering.sample_along_rays(
      origins, directions, model.num_coarse_samples, model.near, model.far,
      model.use_linear_disparity)
  out = {'coarse': _render_level(params, model, 'coarse', points, z_vals,
                                 directions, viewdirs, metadata, warp_extra,
                                 use_warp, occupancy, keep_coarse)}
  # With coarse culling, z_vals and the weights below are the kept subset:
  # the PDF then places the fine samples inside it.
  z_vals = out['coarse'].pop('kept_z_vals', z_vals)
  if model.num_fine_samples > 0:
    z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_vals, points = rendering.sample_pdf(
        z_vals_mid, out['coarse']['weights'][..., 1:-1], origins,
        directions, z_vals, model.num_fine_samples)
    out['fine'] = _render_level(params, model, 'fine', points, z_vals,
                                directions, viewdirs, metadata, warp_extra,
                                use_warp, occupancy, keep_fine)
    out['fine'].pop('kept_z_vals', None)
  if not return_weights:
    for level in out.values():
      level.pop('weights', None)
  return out
