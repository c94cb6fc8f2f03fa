"""Loads a JAX param tree into the port, by name.

A JAX tree (from nerfies_tpu.models.nerf.construct_nerf, or a checkpoint)
is handed over as nested mappings of numpy arrays; this module needs
neither JAX nor Flax. Names and the (in, out) kernel layout are kept, so
the result is a param tree of the port as it stands.
"""

from typing import Mapping

import numpy as np
import torch

from nerfies_tpu_torch import resolve_device


def params_from_jax(tree: Mapping, device='cuda') -> dict:
  """Nested mapping of array leaves -> nested dict of float32 tensors."""
  device = resolve_device(device)

  def convert(node):
    if isinstance(node, Mapping):
      return {str(k): convert(v) for k, v in node.items()}
    array = np.asarray(node, dtype=np.float32)
    return torch.from_numpy(array.copy()).to(device)

  return convert(tree)
