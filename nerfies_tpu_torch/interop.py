"""Loads a JAX param tree, a JAX train state or an upstream checkpoint's
params into the port, by name.

A JAX tree (from nerfies_tpu.models.nerf.construct_nerf, or a checkpoint)
is handed over as nested mappings of numpy arrays; this module needs
neither JAX nor Flax nor optax. Names and the (in, out) kernel layout are
kept, so the result is a param tree of the port as it stands.

An upstream google/nerfies param tree (its models.py `setup`) differs from
the JAX package's only by names and one concat, as in
nerfies_tpu/interop.py: `map_reference_params` renames it (numpy in,
numpy out), and `params_from_jax` then loads it:

  nerf_mlps_{coarse,fine}/MLP_0  -> trunk ('hidden_i')
  nerf_mlps_{coarse,fine}/MLP_1  -> rgb branch ('hidden_i' + 'logit')
  nerf_mlps_{coarse,fine}/MLP_2  -> alpha branch ('hidden_i' + 'logit')
  nerf_mlps_{coarse,fine}/bottleneck
  warp_field/{trunk,branches_w,branches_v[,branches_p,branches_t],
              metadata_encoder}; depth-0 branches_w/branches_v heads
              concatenated into branches_wv
  {appearance,camera}_encoder/embed/embedding
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

from nerfies_tpu_torch import resolve_device


def map_nerf_mlp(ref_mlp: Mapping[str, Any]) -> Dict[str, Any]:
  """Upstream NerfMLP params (MLP_0/1/2 + bottleneck) -> the package's
  names."""
  out = {}
  for name, ours in (('MLP_0', 'trunk'), ('MLP_1', 'rgb'), ('MLP_2', 'alpha')):
    for layer, arrs in dict(ref_mlp[name]).items():
      # 'logit' -> '<ours>_logit', 'hidden_i' -> '<ours>_hidden_i'.
      out[f'{ours}_{layer}'] = arrs
  if 'bottleneck' in ref_mlp:
    out['bottleneck'] = ref_mlp['bottleneck']
  return out


def map_warp_field(ref_warp: Mapping[str, Any],
                   fuse_branch_heads: bool = True) -> Dict[str, Any]:
  """Upstream warp-field params -> the package's warp-field params."""
  out = {}
  for key, value in dict(ref_warp).items():
    if key in ('branches_w', 'branches_v') and fuse_branch_heads:
      continue
    out[key] = value
  if fuse_branch_heads and 'branches_w' in ref_warp:
    w, v = dict(ref_warp['branches_w']), dict(ref_warp['branches_v'])
    if set(w) == {'logit'}:  # depth-0 heads fuse into one (width, 6) matmul
      out['branches_wv'] = {'logit': {
          'kernel': np.concatenate(
              [np.asarray(w['logit']['kernel']),
               np.asarray(v['logit']['kernel'])], axis=-1),
          'bias': np.concatenate(
              [np.asarray(w['logit']['bias']),
               np.asarray(v['logit']['bias'])], axis=-1),
      }}
    else:  # deep branches are kept separate in both implementations
      out['branches_w'] = w
      out['branches_v'] = v
  return out


def map_reference_params(ref_params: Mapping[str, Any],
                         fuse_branch_heads: bool = True) -> Dict[str, Any]:
  """Maps an upstream `params` collection to the package's layout.

  Args:
    ref_params: the 'params' tree of the upstream model, as nested
      mappings of arrays.
    fuse_branch_heads: whether the target SE(3) field fuses the depth-0
      w/v heads (the package's default).

  Returns:
    A tree for `params_from_jax`, then `NerfModel`.
  """
  out = {}
  for key, value in dict(ref_params).items():
    if key.startswith('nerf_mlps_'):
      out[key] = map_nerf_mlp(dict(value))
    elif key == 'warp_field':
      out[key] = map_warp_field(dict(value), fuse_branch_heads)
    else:  # embedding encoders: identical structure
      out[key] = value
  return out


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
