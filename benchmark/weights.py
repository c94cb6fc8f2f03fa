"""The model's weights, made on the device from the seed.

The layout is the published model's (google/nerfies `NerfModel`, the Flax
names and (in, out) Dense kernels), worked out here from a configuration's
widths. Both the program and the plain reference are handed the same
tensors; neither makes weights of its own.

The values follow the published initialisers: Glorot-uniform kernels, zero
biases, GLO tables U[0, 0.05) and the SE(3) head U[0, 1e-4). All of them
come from one `torch.rand` call on the card; each leaf is a scaled slice
of it, in float32 (the master weights the program trains and serves).
"""

from typing import Dict, List, Tuple

import torch

Layout = List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]


def posenc_dims(channels: int, num_freqs: int, identity: bool = True) -> int:
  return channels * (2 * num_freqs + (1 if identity else 0))


def rgb_condition_dims(model: Dict) -> int:
  dims = posenc_dims(3, model['num_nerf_viewdir_freqs'])
  if model['use_appearance_metadata'] and model['use_rgb_condition']:
    dims += model['appearance_metadata_dims']
  if model['use_camera_metadata']:
    dims += model['camera_metadata_dims']
  return dims


def _dense(layout: Layout, path, in_dims: int, out_dims: int,
           kernel_init: str = 'glorot') -> None:
  layout.append((path + ('kernel',), (in_dims, out_dims), kernel_init))
  layout.append((path + ('bias',), (out_dims,), 'zeros'))


def layout(model: Dict, num_ids: Dict[str, int]) -> Layout:
  """(path, shape, initialiser) of every leaf, in a fixed order.

  num_ids: table sizes {'warp', 'camera', 'appearance'}.
  """
  out: Layout = []
  if model['use_warp']:
    if model['warp_field_type'] != 'se3':
      raise ValueError('only the SE(3) warp field is laid out here')
    features = model['num_warp_features']
    pe = posenc_dims(3, model['num_warp_freqs'])
    width, depth, skips = 128, 6, (4,)
    out.append((('warp_field', 'metadata_encoder', 'embed', 'embedding'),
                (num_ids['warp'], features), 'glo'))
    prev = None
    for i in range(depth):
      in_dims = pe + features if prev is None else (
          prev + pe + features if i in skips else prev)
      _dense(out, ('warp_field', 'trunk', f'hidden_{i}'), in_dims, width)
      prev = width
    _dense(out, ('warp_field', 'branches_wv', 'logit'), width, 6, 'head')
  if model['use_appearance_metadata']:
    out.append((('appearance_encoder', 'embed', 'embedding'),
                (num_ids['appearance'], model['appearance_metadata_dims']),
                'glo'))
  if model['use_camera_metadata']:
    out.append((('camera_encoder', 'embed', 'embedding'),
                (num_ids['camera'], model['camera_metadata_dims']), 'glo'))
  point = posenc_dims(3, model['num_nerf_point_freqs'])
  width = model['nerf_trunk_width']
  levels = ['coarse'] + (['fine'] if model['num_fine_samples'] > 0 else [])
  for level in levels:
    root = (f'nerf_mlps_{level}',)
    prev = None
    for i in range(model['nerf_trunk_depth']):
      in_dims = point if prev is None else (
          prev + point if i in model['nerf_skips'] else prev)
      _dense(out, root + (f'trunk_hidden_{i}',), in_dims, width)
      prev = width
    _dense(out, root + ('bottleneck',), width, width)
    _dense(out, root + ('alpha_logit',), width, model['alpha_channels'])
    rgb_width = model['nerf_rgb_branch_width']
    in_dims = width + rgb_condition_dims(model)
    for i in range(model['nerf_rgb_branch_depth']):
      _dense(out, root + (f'rgb_hidden_{i}',), in_dims, rgb_width)
      in_dims = rgb_width
    _dense(out, root + ('rgb_logit',), in_dims, model['rgb_channels'])
  return out


def make(model: Dict, num_ids: Dict[str, int], seed: int,
         device) -> Dict[str, object]:
  """The nested param tree of `layout`, drawn on `device` from `seed`."""
  leaves = layout(model, num_ids)
  sizes = [_numel(shape) for _, shape, _ in leaves]
  generator = torch.Generator(device=device).manual_seed(seed % (1 << 63))
  flat = torch.rand(sum(sizes), generator=generator, device=device)
  tree: Dict[str, object] = {}
  offset = 0
  for (path, shape, init), size in zip(leaves, sizes):
    u = flat[offset:offset + size].view(shape)
    offset += size
    if init == 'glorot':
      value = (2.0 * u - 1.0) * (6.0 / (shape[0] + shape[1])) ** 0.5
    elif init == 'glo':
      value = 0.05 * u
    elif init == 'head':
      value = 1e-4 * u
    else:
      value = torch.zeros_like(u)
    node = tree
    for key in path[:-1]:
      node = node.setdefault(key, {})
    node[path[-1]] = value
  return tree


def _numel(shape) -> int:
  n = 1
  for s in shape:
    n *= s
  return n


def flatten(tree, prefix: str = '') -> Dict[str, torch.Tensor]:
  """{'a/b/kernel': tensor} of a nested dict of tensors."""
  out = {}
  for key, value in tree.items():
    name = f'{prefix}/{key}' if prefix else key
    if isinstance(value, dict):
      out.update(flatten(value, name))
    else:
      out[name] = value
  return out
