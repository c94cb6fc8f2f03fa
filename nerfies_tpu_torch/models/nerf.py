"""The deformable NeRF model: its parameters, architecture and forward.

`construct_nerf` returns the nested-dict param tree with exactly the names
and shapes of nerfies_tpu.models.nerf.construct_nerf, drawn from a
torch.Generator; its leaves are trainable (requires_grad). `NerfModel`
holds that tree and the architecture. Its `forward(params, rays, ...)` is
the Flax NerfModel's `__call__` (`model.apply`): plain PyTorch over the
tree, with `torch.matmul` products in float32, or in bf16 under
`use_bfloat16`, as the Flax modules compute them. The JAX package's fused
paths, which the port runs through its kernels, are fast_render.render_rays
(serving) and fused_train.model_forward (training); `fused_route` says
which of the two train-step routes the model takes, as JAX decides it.
"""

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import checkpoint

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import fused_train
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch.models import glo
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.models import warping
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import rendering


def _to_module(tree: dict) -> nn.Module:
  """Nested dict of tensors -> ModuleDict of trainable ParameterDicts."""
  if all(isinstance(v, torch.Tensor) for v in tree.values()):
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=True) for k, v in tree.items()})
  return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _to_tree(module: nn.Module) -> dict:
  if isinstance(module, nn.ParameterDict):
    return {k: v for k, v in module.items()}
  return {k: _to_tree(v) for k, v in module.items()}


class NerfModel(nn.Module):
  """Holds the param tree and the static architecture of one NeRF model.

  The attributes are those of the Flax NerfModel: every field of the
  config, near/far, the id ranges of the GLO tables, and the train-time
  switches use_warp_jacobian (the coarse level returns dense warp
  Jacobians) and use_weights (the fine level returns its weights).
  """

  def __init__(self, config: configs.ModelConfig, params: dict,
               near: float, far: float, appearance_ids: Sequence[int],
               camera_ids: Sequence[int], warp_ids: Sequence[int],
               use_warp_jacobian: bool = False, use_weights: bool = False):
    super().__init__()
    for field in dataclasses.fields(config):
      setattr(self, field.name, getattr(config, field.name))
    self.nerf_skips = tuple(config.nerf_skips)
    self.warp_kwargs = dict(config.warp_kwargs)
    self.near = near
    self.far = far
    self.appearance_ids = tuple(appearance_ids)
    self.camera_ids = tuple(camera_ids)
    self.warp_ids = tuple(warp_ids)
    self.use_warp_jacobian = use_warp_jacobian
    self.use_weights = use_weights
    self.metadata_encoded = False
    self.tree = _to_module(params)

  @property
  def params(self) -> Dict[str, dict]:
    """The nested-dict param tree (the tensors this module holds)."""
    return _to_tree(self.tree)

  @property
  def sigma_activation_fn(self):
    return configs.ACTIVATIONS[self.sigma_activation]

  @property
  def activation_fn(self):
    return configs.ACTIVATIONS[self.activation]

  @property
  def compute_dtype(self) -> Optional[torch.dtype]:
    return torch.bfloat16 if self.use_bfloat16 else None

  @property
  def fused_route(self) -> bool:
    """Whether the train step runs fused_train.model_forward (the kernels)
    rather than `forward`: nerfies_tpu/training.py:277's rule."""
    return bool(self.use_fused_mlp and fused_train.supported(self))

  def _remat(self, fn, policy: Optional[str] = None):
    """fn under torch.utils.checkpoint when use_remat asks for it and a
    graph is being recorded. policy 'dots' keeps the products' outputs
    (jax.checkpoint_policies.dots_saveable); otherwise all is recomputed."""
    if not (self.use_remat and torch.is_grad_enabled()):
      return fn
    context_fn = checkpoint.noop_context_fn
    if policy == 'dots':
      context_fn = functools.partial(
          checkpoint.create_selective_checkpoint_contexts, _save_products)
    return functools.partial(checkpoint.checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)

  def warp_field(self, params: dict, points: torch.Tensor,
                 warp_metadata: torch.Tensor, warp_extra: dict,
                 return_jacobian: bool = False,
                 metadata_encoded: bool = False) -> dict:
    """The plain warp field (warping.apply_field) in the model's compute
    dtype, rematerialized as the Flax field is under use_remat."""
    fn = functools.partial(warping.apply_field, self, params['warp_field'],
                           return_jacobian=return_jacobian,
                           metadata_encoded=metadata_encoded,
                           dtype=self.compute_dtype)
    return self._remat(fn)(points, warp_metadata, warp_extra)

  def apply_warp(self, params: dict, points: torch.Tensor,
                 warp_metadata: torch.Tensor, warp_extra: dict,
                 return_jacobian: bool = False) -> dict:
    """Warps an arbitrary (..., 3) point set with the shared warp params.

    The counterpart of the Flax NerfModel.apply_warp: {'warped_points'}
    and, with return_jacobian, the (3, 3, ...) 'jacobian'. On the fused
    route with use_fused_warp, through the warp kernel
    (fused_train.apply_warp, (B, S, 3) points); otherwise through the
    plain field, as JAX's is.
    """
    if self.fused_route and self.use_fused_warp:
      return fused_train.apply_warp(self, params, points, warp_metadata,
                                    warp_extra, return_jacobian)
    return self.warp_field(params, points, warp_metadata, warp_extra,
                           return_jacobian)

  def get_condition_inputs(self, params: dict, viewdirs: torch.Tensor,
                           metadata: Dict[str, torch.Tensor],
                           metadata_encoded: bool = False):
    """Per-ray (B, C) trunk, alpha and rgb conditions, each None if empty."""
    trunk, alpha, rgb = [], [], []
    if self.use_viewdirs:
      rgb.append(encoding.posenc(viewdirs,
                                 num_freqs=self.num_nerf_viewdir_freqs))
    if self.use_appearance_metadata:
      code = (metadata['appearance'] if metadata_encoded
              else glo.lookup(params['appearance_encoder'],
                              metadata['appearance']))
      for wanted, conditions in ((self.use_trunk_condition, trunk),
                                 (self.use_alpha_condition, alpha),
                                 (self.use_rgb_condition, rgb)):
        if wanted:
          conditions.append(code)
    if self.use_camera_metadata:
      rgb.append(metadata['camera'] if metadata_encoded
                 else glo.lookup(params['camera_encoder'],
                                 metadata['camera']))
    concat = lambda cs: torch.cat(cs, dim=-1) if cs else None
    return concat(trunk), concat(alpha), concat(rgb)

  def render_samples(self, params: dict, level: str, points: torch.Tensor,
                     z_vals: torch.Tensor, directions: torch.Tensor,
                     viewdirs: torch.Tensor, metadata: Dict[str, Any],
                     warp_extra: dict, use_warp: bool = True,
                     use_warp_jacobian: bool = False,
                     metadata_encoded: bool = False,
                     return_points: bool = False,
                     return_weights: bool = False,
                     generator: Optional[torch.Generator] = None) -> dict:
    """One sampling level: warp, posenc, the NeRF MLP, compositing.

    `generator` draws the density noise (noise_std, stratified only).
    """
    conditions = self.get_condition_inputs(params, viewdirs, metadata,
                                           metadata_encoded)
    out = {}
    if return_points:
      out['points'] = points
    if use_warp:
      warp_metadata = (metadata['time']
                       if self.warp_metadata_encoder_type == 'time'
                       else metadata['warp'])
      warp_out = self.warp_field(params, points, warp_metadata, warp_extra,
                                 use_warp_jacobian, metadata_encoded)
      points = warp_out['warped_points']
      if 'jacobian' in warp_out:
        out['warp_jacobian'] = warp_out['jacobian']
      if return_points:
        out['warped_points'] = points
    points_embed = encoding.posenc(points,
                                   num_freqs=self.num_nerf_point_freqs)
    nerf_mlp = functools.partial(
        modules.apply_nerf_mlp, params[f'nerf_mlps_{level}'],
        skips=self.nerf_skips, activation=self.activation_fn,
        dtype=self.compute_dtype)
    raw = self._remat(nerf_mlp, self.remat_policy)(points_embed, *conditions)
    raw_sigma = rendering.noise_regularize(
        raw['alpha'][..., 0], self.noise_std, self.use_stratified_sampling,
        generator)
    rgb = torch.sigmoid(raw['rgb'])
    if self.rgb_padding:
      rgb = rgb * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
    out.update(rendering.volumetric_rendering(
        rgb, self.sigma_activation_fn(raw_sigma), z_vals, directions,
        use_white_background=self.use_white_background,
        sample_at_infinity=self.use_sample_at_infinity,
        return_weights=return_weights))
    return out

  def forward(self, params: dict, rays_dict: Dict[str, Any],
              warp_extra: dict, metadata_encoded: bool = False,
              use_warp: bool = True, return_points: bool = False,
              return_weights: bool = False,
              return_warp_jacobian: bool = False,
              coarse_generator: Optional[torch.Generator] = None,
              fine_generator: Optional[torch.Generator] = None) -> dict:
    """Renders a ray batch at the coarse (+ fine) level: `model.apply`.

    Args:
      params: the param tree, on the rays' device.
      rays_dict: {'origins', 'directions' (B, 3), 'viewdirs'?,
        'metadata': {'warp' / 'camera' / 'appearance' (B, 1) ids,
        'time' (B, 1) float}} as tensors.
      warp_extra: {'alpha', 'time_alpha'} annealing scalars.
      coarse_generator / fine_generator: each level's random stream
        (stratified jitter, inverse-CDF samples, density noise), in place
        of Flax's make_rng('coarse') and make_rng('fine'); required when
        the model samples stratified.

    Returns:
      {'coarse': {...}, 'fine'?: {...}}: rgb, depth, med_depth, acc, and
      weights, points, warped_points, warp_jacobian as asked for. The
      coarse level computes warp Jacobians when use_warp_jacobian or
      return_warp_jacobian; the fine level keeps its weights when
      use_weights or return_weights.
    """
    stratified = self.use_stratified_sampling
    if stratified and (coarse_generator is None or fine_generator is None):
      raise ValueError('stratified sampling needs a generator per level')
    if not stratified:
      coarse_generator = fine_generator = None
    use_warp = self.use_warp and use_warp
    return_weights_out = self.use_weights or return_weights
    origins = rays_dict['origins']
    directions = rays_dict['directions']
    metadata = rays_dict['metadata']
    viewdirs = rays_dict.get('viewdirs', directions)
    level = functools.partial(
        self.render_samples, params, directions=directions,
        viewdirs=viewdirs, metadata=metadata, warp_extra=warp_extra,
        use_warp=use_warp, metadata_encoded=metadata_encoded,
        return_points=return_points)

    z_vals, points = rendering.sample_along_rays(
        origins, directions, self.num_coarse_samples, self.near, self.far,
        self.use_linear_disparity, coarse_generator)
    out = {'coarse': level(
        'coarse', points, z_vals,
        use_warp_jacobian=return_warp_jacobian or self.use_warp_jacobian,
        return_weights=True, generator=coarse_generator)}
    if self.num_fine_samples > 0:
      z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
      z_vals, points = rendering.sample_pdf(
          z_vals_mid, out['coarse']['weights'][..., 1:-1], origins,
          directions, z_vals, self.num_fine_samples, fine_generator)
      out['fine'] = level('fine', points, z_vals,
                          use_warp_jacobian=return_warp_jacobian,
                          return_weights=return_weights_out,
                          generator=fine_generator)
    if not return_weights_out:
      del out['coarse']['weights']
    return out


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
  """Selective-checkpoint policy of remat_policy 'dots': keep products."""
  del ctx, args, kwargs
  if op in _PRODUCTS:
    return checkpoint.CheckpointPolicy.MUST_SAVE
  return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def param_tree(config: configs.ModelConfig,
               appearance_ids: Sequence[int],
               camera_ids: Sequence[int],
               warp_ids: Sequence[int],
               generator: Optional[torch.Generator] = None) -> dict:
  """The param tree of construct_nerf, on the CPU."""
  point_dims = encoding.posenc_output_dim(3, config.num_nerf_point_freqs)
  appearance = (config.appearance_metadata_dims
                if config.use_appearance_metadata else 0)
  rgb_dims = 0
  if config.use_viewdirs:
    rgb_dims += encoding.posenc_output_dim(3, config.num_nerf_viewdir_freqs)
  if config.use_rgb_condition:
    rgb_dims += appearance
  if config.use_camera_metadata:
    rgb_dims += config.camera_metadata_dims
  mlp_kwargs = dict(
      point_dims=point_dims,
      trunk_condition_dims=appearance if config.use_trunk_condition else 0,
      alpha_condition_dims=appearance if config.use_alpha_condition else 0,
      rgb_condition_dims=rgb_dims,
      trunk_depth=config.nerf_trunk_depth,
      trunk_width=config.nerf_trunk_width,
      rgb_branch_depth=config.nerf_rgb_branch_depth,
      rgb_branch_width=config.nerf_rgb_branch_width,
      rgb_channels=config.rgb_channels,
      alpha_channels=config.alpha_channels,
      skips=tuple(config.nerf_skips),
      generator=generator)

  params = {}
  if config.use_warp:
    params['warp_field'] = warping.create_warp_field(
        field_type=config.warp_field_type,
        num_freqs=config.num_warp_freqs,
        num_embeddings=max(warp_ids) + 1,
        num_features=config.num_warp_features,
        metadata_encoder_type=config.warp_metadata_encoder_type,
        generator=generator,
        **dict(config.warp_kwargs))
  if config.use_appearance_metadata:
    params['appearance_encoder'] = glo.glo_encoder(
        max(appearance_ids) + 1, config.appearance_metadata_dims, generator)
  if config.use_camera_metadata:
    params['camera_encoder'] = glo.glo_encoder(
        max(camera_ids) + 1, config.camera_metadata_dims, generator)
  params['nerf_mlps_coarse'] = modules.nerf_mlp(**mlp_kwargs)
  if config.num_fine_samples > 0:
    params['nerf_mlps_fine'] = modules.nerf_mlp(**mlp_kwargs)
  return params


def _tree_to(tree: dict, device: torch.device) -> dict:
  return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
          for k, v in tree.items()}


def construct_nerf(config: configs.ModelConfig,
                   appearance_ids: Sequence[int],
                   camera_ids: Sequence[int],
                   warp_ids: Sequence[int],
                   near: float,
                   far: float,
                   *,
                   generator: Optional[torch.Generator] = None,
                   device='cuda',
                   use_warp_jacobian: bool = False,
                   use_weights: bool = False) -> Tuple[NerfModel, dict]:
  """Builds a NerfModel from a ModelConfig with freshly drawn parameters.

  The counterpart of nerfies_tpu.models.nerf.construct_nerf: the JAX key
  becomes `generator` (a CPU torch.Generator; the draws differ from
  JAX's) and the init batch size, which only shaped the JAX init pass, is
  gone.

  Returns:
    (model, params): params is the nested-dict tree on `device`, the same
    tensors that model.params returns.
  """
  device = resolve_device(device)
  params = _tree_to(param_tree(config, appearance_ids, camera_ids, warp_ids,
                               generator), device)
  model = NerfModel(config, params, near, far, appearance_ids, camera_ids,
                    warp_ids, use_warp_jacobian, use_weights)
  return model, model.params
