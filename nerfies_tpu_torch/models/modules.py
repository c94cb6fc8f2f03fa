"""Parameter-tree builders for MLP, SplitDense and NerfMLP.

The trees have the names and shapes that the Flax modules of
nerfies_tpu/models/modules.py create: Dense kernels in the (in, out)
layout, so a JAX tree loads by name (interop.params_from_jax). A
SplitDense over inputs of widths C_i has one (sum C_i, features) kernel,
as in the JAX package. Kernels are Glorot-uniform and biases zero, drawn
from an explicit torch.Generator; the values differ from JAX's draws.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Tree = Dict[str, object]
Init = Callable[[Tuple[int, ...], Optional[torch.Generator]], torch.Tensor]


def glorot_uniform(shape: Tuple[int, int],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)) for an (in, out) kernel."""
  limit = (6.0 / (shape[0] + shape[1])) ** 0.5
  u = torch.rand(shape, generator=generator, dtype=torch.float32)
  return (2.0 * u - 1.0) * limit


def uniform_init(scale: float) -> Init:
  """U[0, scale), as flax.linen.initializers.uniform(scale)."""
  def init(shape, generator=None):
    return scale * torch.rand(shape, generator=generator, dtype=torch.float32)
  return init


def split_dense(in_dims: Sequence[int], features: int,
                generator: Optional[torch.Generator] = None,
                kernel_init: Init = glorot_uniform) -> Tree:
  """{'kernel': (sum(in_dims), features), 'bias': (features,)}."""
  return {'kernel': kernel_init((sum(in_dims), features), generator),
          'bias': torch.zeros(features, dtype=torch.float32)}


def mlp(in_dims: Sequence[int], depth: int, width: int,
        skips: Sequence[int] = (), output_channels: int = 0,
        generator: Optional[torch.Generator] = None,
        hidden_init: Init = glorot_uniform,
        output_init: Init = glorot_uniform) -> Tree:
  """modules.MLP: 'hidden_i' layers (skips re-read the inputs) and 'logit'."""
  tree = {}
  prev = None
  for i in range(depth):
    dims = (list(in_dims) if prev is None
            else ([prev] + list(in_dims) if i in skips else [prev]))
    tree[f'hidden_{i}'] = split_dense(dims, width, generator, hidden_init)
    prev = width
  if output_channels > 0:
    dims = list(in_dims) if prev is None else [prev]
    tree['logit'] = split_dense(dims, output_channels, generator, output_init)
  elif prev is None:
    raise ValueError('depth == 0 with no output head.')
  return tree


def nerf_mlp(point_dims: int,
             trunk_condition_dims: int = 0,
             alpha_condition_dims: int = 0,
             rgb_condition_dims: int = 0,
             trunk_depth: int = 8,
             trunk_width: int = 256,
             rgb_branch_depth: int = 1,
             rgb_branch_width: int = 128,
             rgb_channels: int = 3,
             alpha_branch_depth: int = 0,
             alpha_branch_width: int = 128,
             alpha_channels: int = 1,
             skips: Sequence[int] = (4,),
             generator: Optional[torch.Generator] = None) -> Tree:
  """modules.NerfMLP: trunk, optional bottleneck, alpha and rgb branches.

  A condition width of 0 means the condition is absent. A branch with a
  condition reads [bottleneck, condition]; one without reads the trunk.
  """
  trunk_inputs = [point_dims] + ([trunk_condition_dims]
                                 if trunk_condition_dims else [])
  tree = {}
  prev = None
  for i in range(trunk_depth):
    dims = (trunk_inputs if prev is None
            else ([prev] + trunk_inputs if i in skips else [prev]))
    tree[f'trunk_hidden_{i}'] = split_dense(dims, trunk_width, generator)
    prev = trunk_width
  if alpha_condition_dims or rgb_condition_dims:
    tree['bottleneck'] = split_dense([trunk_width], trunk_width, generator)

  def branch(name, condition_dims, depth, width, out_channels):
    inputs = ([trunk_width] if not condition_dims
              else [trunk_width, condition_dims])
    dims = inputs
    for i in range(depth):
      tree[f'{name}_hidden_{i}'] = split_dense(dims, width, generator)
      dims = [width]
    tree[f'{name}_logit'] = split_dense(dims, out_channels, generator)

  branch('alpha', alpha_condition_dims, alpha_branch_depth,
         alpha_branch_width, alpha_channels)
  branch('rgb', rgb_condition_dims, rgb_branch_depth, rgb_branch_width,
         rgb_channels)
  return tree
