"""The deformable NeRF model's parameters and static architecture.

`construct_nerf` returns the nested-dict param tree with exactly the names
and shapes of nerfies_tpu.models.nerf.construct_nerf, drawn from a
torch.Generator. `NerfModel` holds that tree and the architecture that
fast_render reads; it has no forward of its own (serving goes through
fast_render.render_rays, as in the JAX package).
"""

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch.models import glo
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.models import warping
from nerfies_tpu_torch.ops import encoding


def _to_module(tree: dict) -> nn.Module:
  """Nested dict of tensors -> ModuleDict of ParameterDicts (no grads)."""
  if all(isinstance(v, torch.Tensor) for v in tree.values()):
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
  return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _to_tree(module: nn.Module) -> dict:
  if isinstance(module, nn.ParameterDict):
    return {k: v for k, v in module.items()}
  return {k: _to_tree(v) for k, v in module.items()}


class NerfModel(nn.Module):
  """Holds the param tree and the static architecture of one NeRF model.

  The attributes are those of the Flax NerfModel: every field of the
  config, plus near/far and the id ranges of the GLO tables.
  """

  def __init__(self, config: configs.ModelConfig, params: dict,
               near: float, far: float, appearance_ids: Sequence[int],
               camera_ids: Sequence[int], warp_ids: Sequence[int]):
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
    self.metadata_encoded = False
    self.tree = _to_module(params)

  @property
  def params(self) -> Dict[str, dict]:
    """The nested-dict param tree (the tensors this module holds)."""
    return _to_tree(self.tree)

  @property
  def sigma_activation_fn(self):
    return configs.ACTIVATIONS[self.sigma_activation]


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
                   device='cuda') -> Tuple[NerfModel, dict]:
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
                    warp_ids)
  return model, model.params
