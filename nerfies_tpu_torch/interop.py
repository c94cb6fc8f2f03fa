"""Loads a JAX param tree, or a JAX train state, into the port, by name.

A JAX tree (from nerfies_tpu.models.nerf.construct_nerf, or a checkpoint)
is handed over as nested mappings of numpy arrays; this module needs
neither JAX nor Flax nor optax. Names and the (in, out) kernel layout are
kept, so the result is a param tree of the port as it stands.
"""

from typing import Any, Mapping

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


def train_state_from_jax(params: Mapping, adam_state: Any, step: int = 0,
                         warp_alpha: float = 0.0, time_alpha: float = 0.0,
                         device='cuda'):
  """A JAX train state -> training.TrainState of the port.

  Args:
    params: the param tree, as nested mappings of arrays.
    adam_state: optax's ScaleByAdamState (or any object or mapping with
      `count`, `mu` and `nu`), its trees as nested mappings of arrays.
    step / warp_alpha / time_alpha: the state's scalars.
  """
  from nerfies_tpu_torch import training
  get = ((lambda k: adam_state[k]) if isinstance(adam_state, Mapping)
         else (lambda k: getattr(adam_state, k)))
  frozen = lambda tree: training._map(lambda t: t.requires_grad_(False),
                                      params_from_jax(tree, device))
  return training.TrainState(
      step=int(step),
      params=training._map(training._trainable,
                           params_from_jax(params, device)),
      opt_state=training.AdamState(int(np.asarray(get('count'))),
                                   frozen(get('mu')), frozen(get('nu'))),
      warp_alpha=float(warp_alpha), time_alpha=float(time_alpha))
