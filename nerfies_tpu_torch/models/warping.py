"""Parameter trees of the deformation fields (nerfies_tpu/models/warping.py).

`se3_field` covers both head layouts of SE3Field: the fused (width, 6)
head 'branches_wv' and the separate 'branches_w' / 'branches_v' heads.
Only the GLO metadata encoder is ported; the time encoder waits.
"""

from typing import Optional, Sequence

import torch

from nerfies_tpu_torch.models import glo
from nerfies_tpu_torch.models import modules
from nerfies_tpu_torch.ops import encoding


def _metadata_encoder(metadata_encoder_type, num_embeddings, features,
                      generator):
  if metadata_encoder_type != 'glo':
    raise NotImplementedError(
        f'metadata encoder {metadata_encoder_type!r} is not ported; only '
        '"glo" is')
  return glo.glo_encoder(num_embeddings, features, generator)


def translation_field(num_freqs: int, num_embeddings: int,
                      num_embedding_features: int,
                      use_identity_map: bool = True,
                      metadata_encoder_type: str = 'glo',
                      skips: Sequence[int] = (4,),
                      depth: int = 6,
                      hidden_channels: int = 128,
                      generator: Optional[torch.Generator] = None) -> dict:
  """TranslationField: {'metadata_encoder', 'mlp': hidden_i + 'logit'}."""
  pe = encoding.posenc_output_dim(3, num_freqs, use_identity_map)
  return {
      'metadata_encoder': _metadata_encoder(
          metadata_encoder_type, num_embeddings, num_embedding_features,
          generator),
      'mlp': modules.mlp([pe, num_embedding_features], depth,
                         hidden_channels, skips, output_channels=3,
                         generator=generator,
                         output_init=modules.uniform_init(1e-4)),
  }


def se3_field(num_freqs: int, num_embeddings: int,
              num_embedding_features: int,
              use_identity_map: bool = True,
              metadata_encoder_type: str = 'glo',
              skips: Sequence[int] = (4,),
              trunk_depth: int = 6,
              trunk_width: int = 128,
              rotation_depth: int = 0,
              rotation_width: int = 128,
              pivot_depth: int = 0,
              pivot_width: int = 128,
              fuse_branch_heads: bool = True,
              generator: Optional[torch.Generator] = None) -> dict:
  """SE3Field: {'metadata_encoder', 'trunk', 'branches_wv' | 'branches_w/v'}.

  The pivot and translation branches (use_pivot, use_translation) are
  not ported; fast_render does not serve them either.
  """
  pe = encoding.posenc_output_dim(3, num_freqs, use_identity_map)
  tree = {
      'metadata_encoder': _metadata_encoder(
          metadata_encoder_type, num_embeddings, num_embedding_features,
          generator),
      'trunk': modules.mlp([pe, num_embedding_features], trunk_depth,
                           trunk_width, skips, generator=generator),
  }
  small = modules.uniform_init(1e-4)
  if fuse_branch_heads and rotation_depth == 0 and pivot_depth == 0:
    tree['branches_wv'] = modules.mlp([trunk_width], 0, rotation_width,
                                      output_channels=6, generator=generator,
                                      output_init=small)
  else:
    tree['branches_w'] = modules.mlp([trunk_width], rotation_depth,
                                     rotation_width, output_channels=3,
                                     generator=generator, output_init=small)
    tree['branches_v'] = modules.mlp([trunk_width], pivot_depth, pivot_width,
                                     output_channels=3, generator=generator,
                                     output_init=small)
  return tree


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
  for unported in ('use_pivot', 'use_translation'):
    if kwargs.pop(unported, False):
      raise NotImplementedError(f'{unported} is not ported')
  return build(num_freqs=num_freqs, num_embeddings=num_embeddings,
               num_embedding_features=num_features,
               metadata_encoder_type=metadata_encoder_type,
               generator=generator, **kwargs)
