"""Deformation fields (nerfies_tpu/models/warping.py): trees and forwards.

`translation_field` and `se3_field` build the param trees of
TranslationField and SE3Field, with their metadata encoders ('glo',
'time', 'blend') and the SE(3) field's head layouts: the fused (width, 6)
head 'branches_wv', separate 'branches_w' / 'branches_v', and the pivot
'branches_p' and translation 'branches_t' branches.

`apply_field` is the fields' `__call__` over such a tree, the plain
version of the warp: `encode_metadata`, posenc, the MLP of
models/modules.py and `rigid.se3_apply_raw`. With `return_jacobian` it
also returns d warped / d points in the (3, 3, ...) leading layout of
ops/svd3.py, from one primal and three broadcast basis tangents
(`torch.func.jvp` under `torch.func.vmap`, the counterpart of
`jax.linearize`); the elastic loss differentiates through it.
"""

import functools
from typing import Any, Dict, Optional, Sequence

import torch

from nerfies_tpu_torch.models import glo
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.ops import rigid


def _metadata_encoder(metadata_encoder_type, num_embeddings, features,
                      num_freqs, generator):
  if metadata_encoder_type == 'glo':
    return {'metadata_encoder': glo.glo_encoder(num_embeddings, features,
                                                generator)}
  if metadata_encoder_type == 'time':
    return {'metadata_encoder': modules.time_encoder(num_freqs, features,
                                                     generator)}
  if metadata_encoder_type == 'blend':
    return {'glo_encoder': glo.glo_encoder(num_embeddings, features,
                                           generator),
            'time_encoder': modules.time_encoder(num_freqs, features,
                                                 generator)}
  raise ValueError(
      f'Unknown metadata encoder type {metadata_encoder_type}')


def translation_field(num_freqs: int, num_embeddings: int,
                      num_embedding_features: int,
                      use_identity_map: bool = True,
                      min_freq_log2: float = 0.0,
                      max_freq_log2: Optional[float] = None,
                      metadata_encoder_type: str = 'glo',
                      metadata_encoder_num_freqs: int = 1,
                      skips: Sequence[int] = (4,),
                      depth: int = 6,
                      hidden_channels: int = 128,
                      generator: Optional[torch.Generator] = None) -> dict:
  """TranslationField: its metadata encoder and 'mlp': hidden_i + 'logit'.

  min_freq_log2 and max_freq_log2 set the encoding's bands, which the
  warp reads from the model's warp_kwargs; they shape no param.
  """
  del min_freq_log2, max_freq_log2
  pe = encoding.posenc_output_dim(3, num_freqs, use_identity_map)
  return {
      **_metadata_encoder(metadata_encoder_type, num_embeddings,
                          num_embedding_features, metadata_encoder_num_freqs,
                          generator),
      'mlp': modules.mlp([pe, num_embedding_features], depth,
                         hidden_channels, skips, output_channels=3,
                         generator=generator,
                         output_init=modules.uniform_init(1e-4)),
  }


def se3_field(num_freqs: int, num_embeddings: int,
              num_embedding_features: int,
              use_identity_map: bool = True,
              min_freq_log2: float = 0.0,
              max_freq_log2: Optional[float] = None,
              metadata_encoder_type: str = 'glo',
              metadata_encoder_num_freqs: int = 1,
              skips: Sequence[int] = (4,),
              trunk_depth: int = 6,
              trunk_width: int = 128,
              rotation_depth: int = 0,
              rotation_width: int = 128,
              pivot_depth: int = 0,
              pivot_width: int = 128,
              translation_depth: int = 0,
              translation_width: int = 128,
              use_pivot: bool = False,
              use_translation: bool = False,
              fuse_branch_heads: bool = True,
              generator: Optional[torch.Generator] = None) -> dict:
  """SE3Field: its metadata encoder, 'trunk' and the 'branches_*' heads.

  min_freq_log2 and max_freq_log2 shape no param, as in translation_field.
  """
  del min_freq_log2, max_freq_log2
  pe = encoding.posenc_output_dim(3, num_freqs, use_identity_map)
  tree = {
      **_metadata_encoder(metadata_encoder_type, num_embeddings,
                          num_embedding_features, metadata_encoder_num_freqs,
                          generator),
      'trunk': modules.mlp([pe, num_embedding_features], trunk_depth,
                           trunk_width, skips, generator=generator),
  }
  small = modules.uniform_init(1e-4)
  branch = functools.partial(modules.mlp, [trunk_width], output_channels=3,
                             generator=generator, output_init=small)
  if _fused_heads(fuse_branch_heads, rotation_depth, pivot_depth):
    tree['branches_wv'] = modules.mlp([trunk_width], 0, rotation_width,
                                      output_channels=6, generator=generator,
                                      output_init=small)
  else:
    tree['branches_w'] = branch(rotation_depth, rotation_width)
    tree['branches_v'] = branch(pivot_depth, pivot_width)
  if use_pivot:
    tree['branches_p'] = branch(pivot_depth, pivot_width)
  if use_translation:
    tree['branches_t'] = branch(translation_depth, translation_width)
  return tree


def _fused_heads(fuse_branch_heads, rotation_depth, pivot_depth) -> bool:
  return fuse_branch_heads and rotation_depth == 0 and pivot_depth == 0


def create_warp_field(field_type: str, num_freqs: int, num_embeddings: int,
                      num_features: int, metadata_encoder_type: str = 'glo',
                      generator: Optional[torch.Generator] = None,
                      **kwargs) -> dict:
  """Param tree of a 'translation' or 'se3' field."""
  if field_type == 'translation':
    build = translation_field
  elif field_type == 'se3':
    build = se3_field
  else:
    raise ValueError(f'Unknown warp field type: {field_type!r}')
  return build(num_freqs=num_freqs, num_embeddings=num_embeddings,
               num_embedding_features=num_features,
               metadata_encoder_type=metadata_encoder_type,
               generator=generator, **kwargs)


def encode_metadata(model, warp_params: dict, metadata: torch.Tensor,
                    time_alpha=None) -> torch.Tensor:
  """(..., 1) warp ids or times -> (..., F) codes, by the model's
  warp_metadata_encoder_type ('blend' mixes the GLO and the time code by
  time_alpha)."""
  kind = model.warp_metadata_encoder_type
  num_freqs = dict(model.warp_kwargs).get('metadata_encoder_num_freqs', 1)
  if kind == 'glo':
    return glo.lookup(warp_params['metadata_encoder'], metadata)
  if kind == 'time':
    return modules.apply_time_encoder(warp_params['metadata_encoder'],
                                      metadata, num_freqs, time_alpha)
  if kind == 'blend':
    glo_embed = glo.lookup(warp_params['glo_encoder'], metadata)
    time_embed = modules.apply_time_encoder(warp_params['time_encoder'],
                                            metadata, num_freqs)
    return (1.0 - time_alpha) * glo_embed + time_alpha * time_embed
  raise RuntimeError(f'Unknown metadata encoder type {kind}')


def warp(model, warp_params: dict, points: torch.Tensor,
         metadata_embed: torch.Tensor, alpha=None,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """The field's map of (..., 3) points under (per-ray) codes.

  The MLPs run in `dtype`, except the SE(3) pivot and translation
  branches (built without one in JAX); the screw-axis math is float32.
  """
  kwargs = dict(model.warp_kwargs)
  skips = tuple(kwargs.get('skips', (4,)))
  points_embed = encoding.posenc(
      points, num_freqs=model.num_warp_freqs,
      min_freq_log2=kwargs.get('min_freq_log2', 0.0),
      max_freq_log2=kwargs.get('max_freq_log2'),
      use_identity=kwargs.get('use_identity_map', True), alpha=alpha)
  while metadata_embed.dim() < points.dim():
    metadata_embed = metadata_embed[..., None, :]
  inputs = [points_embed, metadata_embed]
  if model.warp_field_type == 'translation':
    return points + modules.apply_mlp(warp_params['mlp'], inputs, skips,
                                      dtype=dtype).to(points.dtype)
  trunk = modules.apply_mlp(warp_params['trunk'], inputs, skips, dtype=dtype)
  head = lambda name, d=dtype: modules.apply_mlp(
      warp_params[name], trunk, dtype=d).to(torch.float32)
  if 'branches_wv' in warp_params:
    wv = head('branches_wv')
    w, v = wv[..., :3], wv[..., 3:]
  else:
    w, v = head('branches_w'), head('branches_v')
  warped = points.to(torch.float32)
  pivot = head('branches_p', None) if 'branches_p' in warp_params else None
  if pivot is not None:
    warped = warped + pivot
  warped = rigid.se3_apply_raw(w, v, warped)
  if pivot is not None:
    warped = warped - pivot
  if 'branches_t' in warp_params:
    warped = warped + head('branches_t', None)
  return warped


def pointwise_jacobian(warp_fn, points: torch.Tensor):
  """Primal and Jacobian of a pointwise (..., 3) -> (..., 3) map.

  One primal pass; the three basis tangents, broadcast over the points,
  run batched beside it. Returns (warped, jacobian (3, 3, ...)) with
  jacobian[i, j] = d out_i / d in_j.
  """
  eye = torch.eye(3, dtype=points.dtype, device=points.device)
  tangents = eye.reshape(3, *([1] * (points.dim() - 1)), 3).expand(
      3, *points.shape)
  warped, columns = torch.func.vmap(
      lambda t: torch.func.jvp(warp_fn, (points,), (t,)),
      out_dims=(None, 0))(tangents)  # columns (j, ..., i)
  return warped, torch.movedim(columns, -1, 0)


def apply_field(model, warp_params: dict, points: torch.Tensor,
                metadata: torch.Tensor, extra: Dict[str, Any],
                return_jacobian: bool = False,
                metadata_encoded: bool = False,
                dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
  """The Flax field's `__call__`: {'warped_points' (..., 3)} and, with
  return_jacobian, 'jacobian' (3, 3, ...).

  Args:
    metadata: (..., 1) ids or times, or (..., F) codes if
      metadata_encoded.
    extra: {'alpha', 'time_alpha'} annealing scalars.
  """
  if metadata_encoded:
    embed = metadata
  else:
    embed = encode_metadata(model, warp_params, metadata,
                            extra.get('time_alpha'))
  fn = lambda p: warp(model, warp_params, p, embed, extra.get('alpha'),
                      dtype)
  if not return_jacobian:
    return {'warped_points': fn(points)}
  warped, jacobian = pointwise_jacobian(fn, points)
  return {'warped_points': warped, 'jacobian': jacobian}
