"""The training forward pass, through the fused kernels.

Port of nerfies_tpu/fused_train.py:46-263. Sampling, the ray conditions,
the SE(3) action and compositing are plain differentiable PyTorch; the
warp trunk runs through `ops.fused_warp.warp_mlp_train` (the primal and,
at the coarse level, the three Jacobian tangent chains), or through the
plain warp field when `use_fused_warp` is False, and the NeRF MLP
through `ops.fused_mlp.nerf_mlp_train`, autograd Functions whose forward
and backward are hand-written kernels on a CUDA tensor and plain versions
on a CPU tensor.

Behavioural notes against the JAX path:
  - Random draws (stratified jitter, inverse-CDF samples, density noise)
    come from one torch.Generator per level, on the rays' device, in
    place of JAX keys: statistically the same, not bit-equal.
    Deterministic sampling compares bit for bit up to float rounding.
  - The rgb condition's product with its rows of the rgb hidden kernel is
    taken once per ray and repeated over the samples (the JAX path repeats
    the condition first): the same bf16 values, S times fewer products.
  - The SE(3) action's Jacobian columns come from `torch.func.jvp` of
    `rigid.se3_apply_raw`, one call per column, in place of one
    `jax.linearize`.
"""

from typing import Any, Dict, Optional

import torch

from nerfies_tpu_torch import fast_render
from nerfies_tpu_torch.models import glo
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import fused_warp
from nerfies_tpu_torch.ops import rendering
from nerfies_tpu_torch.ops import rigid


def supported(model) -> bool:
  """Whether the fused training path covers this model architecture."""
  return fast_render.supported(model)


def check_trainable(model) -> None:
  """Refuses a model or ModelConfig whose fused route the port cannot run.

  The JAX train step runs fused_train.model_forward when `use_fused_mlp`
  and `supported(model)` hold (nerfies_tpu/training.py:277), whatever
  `use_bfloat16` says, and the Flax forward otherwise, which the port
  runs as NerfModel.forward. On the fused route the kernels apply ReLU
  between layers, and JAX's fused path trains an `activation` other than
  relu with ReLU, ignoring the field; the port refuses that config. On
  the plain route the activation is honoured, as in JAX.

  Raises:
    NotImplementedError: for another activation on the fused route.
  """
  if model.use_fused_mlp and supported(model) and model.activation != 'relu':
    raise NotImplementedError(
        f'activation {model.activation!r} on the fused route: the fused '
        'kernels apply relu between layers (the JAX fused path ignores the '
        'field); set use_fused_mlp = False for the plain forward, which '
        'honours it')


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return a.to(torch.bfloat16) @ b.to(torch.bfloat16)


def _warp_layout(model, warp_params):
  """(trunk_depth, skips, {'trunk', 'head'}) of the warp field's params."""
  kwargs = dict(model.warp_kwargs)
  skips = tuple(kwargs.get('skips', (4,)))
  if model.warp_field_type == 'translation':
    mlp_tree = warp_params['mlp']
    trunk = {k: v for k, v in mlp_tree.items() if k.startswith('hidden')}
    return int(kwargs.get('depth', 6)), skips, {
        'trunk': trunk, 'head': {'logit': mlp_tree['logit']}}
  if 'branches_wv' in warp_params:
    head = warp_params['branches_wv']['logit']
  else:
    w_l = warp_params['branches_w']['logit']
    v_l = warp_params['branches_v']['logit']
    head = {'kernel': torch.cat([w_l['kernel'], v_l['kernel']], -1),
            'bias': torch.cat([w_l['bias'], v_l['bias']], -1)}
  return int(kwargs.get('trunk_depth', 6)), skips, {
      'trunk': warp_params['trunk'], 'head': {'logit': head}}


def _stack_jacobian(cols):
  """Columns d warped / d x_j, each (B, S, 3) -> (3, 3, B, S) J[i, j]."""
  return torch.stack([torch.stack([cols[j][..., i] for j in range(3)])
                      for i in range(3)])


def apply_warp(model, params, points, warp_metadata, warp_extra,
               return_jacobian=False) -> Dict[str, torch.Tensor]:
  """SE(3) or translation warp of (B, S, 3) points via the fused trunk.

  The counterpart of fused_train._apply_warp_kernel: the posenc tangent
  columns are analytic (encoding.posenc_with_tangents) and enter the
  kernel as three tangent chains, whose head outputs are the trunk's
  directional derivatives.

  Args:
    points: (B, S, 3); warp_metadata: (B, 1) warp ids.
    return_jacobian: also return the (3, 3, B, S) 'jacobian'.
  """
  warp_params = params['warp_field']
  kwargs = dict(model.warp_kwargs)
  b, s = points.shape[:2]
  n = b * s
  trunk_depth, skips, kparams = _warp_layout(model, warp_params)
  embed = glo.lookup(warp_params['metadata_encoder'], warp_metadata)
  embed_flat = torch.repeat_interleave(embed, s, dim=0)
  pe_kwargs = dict(num_freqs=model.num_warp_freqs,
                   min_freq_log2=kwargs.get('min_freq_log2', 0.0),
                   max_freq_log2=kwargs.get('max_freq_log2'),
                   use_identity=kwargs.get('use_identity_map', True),
                   alpha=warp_extra.get('alpha'))
  if return_jacobian:
    pe, tangents = encoding.posenc_with_tangents(points, **pe_kwargs)
    tangents = tuple(t.reshape(n, -1) for t in tangents)
  else:
    pe, tangents = encoding.posenc(points, **pe_kwargs), ()
  out, jouts = fused_warp.warp_mlp_train(pe.reshape(n, -1), embed_flat,
                                         tangents, kparams, trunk_depth,
                                         skips)
  eye = torch.eye(3, dtype=torch.float32, device=points.device)
  if model.warp_field_type == 'translation':
    ret = {'warped_points': points + out[:, :3].reshape(b, s, 3).to(
        points.dtype)}
    if return_jacobian:
      ret['jacobian'] = _stack_jacobian(
          [jouts[j][:, :3].reshape(b, s, 3) + eye[j] for j in range(3)])
    return ret

  w = out[:, :3].reshape(b, s, 3)
  v = out[:, 3:6].reshape(b, s, 3)
  pts = points.float()
  if not return_jacobian:
    return {'warped_points': rigid.se3_apply_raw(w, v, pts)}
  cols = []
  for j in range(3):
    warped, col = torch.func.jvp(
        rigid.se3_apply_raw, (w, v, pts),
        (jouts[j][:, :3].reshape(b, s, 3), jouts[j][:, 3:6].reshape(b, s, 3),
         eye[j].expand(pts.shape)))
    cols.append(col)
  return {'warped_points': warped, 'jacobian': _stack_jacobian(cols)}


def _mlp_level(params, model, level, points, z_vals, directions,
               rgb_condition, alpha_condition, return_weights,
               noise_generator=None):
  b, s = points.shape[:2]
  pe = encoding.posenc(points, num_freqs=model.num_nerf_point_freqs)
  mlp_params = params[f'nerf_mlps_{level}']
  width = mlp_params['trunk_hidden_0']['kernel'].shape[1]
  rgb_row_bias = None
  if rgb_condition is not None:
    rgb_k = mlp_params['rgb_hidden_0']['kernel']
    rgb_row_bias = torch.repeat_interleave(
        _bf16_matmul(rgb_condition, rgb_k[width:]), s, dim=0)
  alpha, rgb_raw = fused_mlp.nerf_mlp_train(
      pe.reshape(b * s, -1).to(torch.bfloat16), rgb_row_bias, mlp_params,
      model.nerf_trunk_depth, tuple(model.nerf_skips))
  raw_sigma = alpha[:, 0].reshape(b, s)
  if alpha_condition is not None:
    alpha_k = mlp_params['alpha_logit']['kernel']
    raw_sigma = raw_sigma + _bf16_matmul(alpha_condition,
                                         alpha_k[width:]).float()
  rgb = torch.sigmoid(rgb_raw[:, :3].reshape(b, s, 3))
  if model.rgb_padding:
    rgb = rgb * (1.0 + 2.0 * model.rgb_padding) - model.rgb_padding
  raw_sigma = rendering.noise_regularize(
      raw_sigma, model.noise_std, model.use_stratified_sampling,
      noise_generator)
  sigma = model.sigma_activation_fn(raw_sigma)
  return rendering.volumetric_rendering(
      rgb, sigma, z_vals, directions,
      use_white_background=model.use_white_background,
      sample_at_infinity=model.use_sample_at_infinity,
      return_weights=return_weights)


def model_forward(model,
                  params: Dict[str, Any],
                  batch: Dict[str, Any],
                  warp_extra: Dict[str, Any],
                  coarse_generator: Optional[torch.Generator] = None,
                  fine_generator: Optional[torch.Generator] = None,
                  return_points: bool = False,
                  return_weights: bool = False) -> Dict[str, Any]:
  """Train-time forward with `model.apply`'s output contract.

  Mirrors NerfModel.__call__: the coarse level always returns its weights
  (the PDF resampler reads them) and computes warp Jacobians when
  `model.use_warp_jacobian`; the fine level returns its weights when
  `model.use_weights` or `return_weights`.

  Args:
    batch: {'origins', 'directions' (B, 3), 'viewdirs'?, 'metadata':
      {'warp', 'appearance', 'camera': (B, 1) ids}} as tensors on one
      device.
    coarse_generator / fine_generator: the levels' random streams, on
      the batch's device; required when the model samples stratified.
  """
  if not supported(model):
    raise NotImplementedError('the fused training path does not cover this '
                              'model (fused_train.supported)')
  stratified = model.use_stratified_sampling
  if stratified and (coarse_generator is None or fine_generator is None):
    raise ValueError('stratified sampling needs a generator per level')
  if not stratified:
    coarse_generator = fine_generator = None
  origins = batch['origins']
  directions = batch['directions']
  metadata = batch['metadata']
  viewdirs = batch.get('viewdirs', directions)
  _, alpha_condition, rgb_condition = model.get_condition_inputs(
      params, viewdirs, metadata)

  def level_outputs(level, points, z_vals, use_warp_jacobian, want_weights,
                    generator):
    out = {}
    if return_points:
      out['points'] = points
    mlp_points = points
    if model.use_warp:
      # use_fused_warp=False sends the warp through the plain field, as
      # JAX sends it through the Flax module (fused_train.py:215-227).
      if model.use_fused_warp:
        warp_out = apply_warp(model, params, points, metadata['warp'],
                              warp_extra, use_warp_jacobian)
      else:
        warp_out = model.warp_field(params, points, metadata['warp'],
                                    warp_extra, use_warp_jacobian)
      mlp_points = warp_out['warped_points']
      if 'jacobian' in warp_out:
        out['warp_jacobian'] = warp_out['jacobian']
      if return_points:
        out['warped_points'] = mlp_points
    out.update(_mlp_level(params, model, level, mlp_points, z_vals,
                          directions, rgb_condition, alpha_condition,
                          want_weights, noise_generator=generator))
    return out

  z_vals, points = rendering.sample_along_rays(
      origins, directions, model.num_coarse_samples, model.near, model.far,
      model.use_linear_disparity, coarse_generator)
  out = {'coarse': level_outputs('coarse', points, z_vals,
                                 model.use_warp_jacobian, True,
                                 coarse_generator)}
  return_weights_out = model.use_weights or return_weights
  if model.num_fine_samples > 0:
    z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_vals, points = rendering.sample_pdf(
        z_vals_mid, out['coarse']['weights'][..., 1:-1], origins,
        directions, z_vals, model.num_fine_samples, fine_generator)
    out['fine'] = level_outputs('fine', points, z_vals, False,
                                return_weights_out, fine_generator)
  if not return_weights_out:
    del out['coarse']['weights']
  return out
