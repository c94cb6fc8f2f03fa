"""GLO embedding tables (nerfies_tpu/models/glo.py)."""

from typing import Optional

import torch

from nerfies_tpu_torch.models import modules


def glo_encoder(num_embeddings: int, features: int,
                generator: Optional[torch.Generator] = None) -> dict:
  """{'embed': {'embedding': (num_embeddings, features)}}, U[0, 0.05)."""
  table = modules.uniform_init(0.05)((num_embeddings, features), generator)
  return {'embed': {'embedding': table}}


def lookup(encoder_params: dict, ids: torch.Tensor) -> torch.Tensor:
  """(B, 1) or (B,) integer ids -> (B, F) codes."""
  if ids.dim() > 1 and ids.shape[-1] == 1:
    ids = ids[..., 0]
  return encoder_params['embed']['embedding'][ids.long()]
