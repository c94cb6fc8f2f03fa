"""MLP, SplitDense, NerfMLP and TimeEncoder: param trees and forwards.

Port of nerfies_tpu/models/modules.py. The tree builders (`split_dense`,
`mlp`, `nerf_mlp`, `time_encoder`) give the names and shapes that the
Flax modules create: Dense kernels in the (in, out) layout, so a JAX tree
loads by name (interop.params_from_jax). A SplitDense over inputs of
widths C_i has one (sum C_i, features) kernel, as in the JAX package.
Kernels are Glorot-uniform and biases zero, drawn from an explicit
torch.Generator; the values differ from JAX's draws.

The `apply_*` functions are the modules' `__call__`s over such a tree.
Their products are plain `torch.matmul`s: the Flax forward reaches no
Pallas kernel. With `dtype=torch.bfloat16` a SplitDense casts its kernel
slices, bias and inputs to bf16 and sums its terms in bf16, as the Flax
module does; with `dtype=None` the operands meet in their promoted type.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from nerfies_tpu_torch.ops import encoding

Tree = Dict[str, object]
Init = Callable[[Tuple[int, ...], Optional[torch.Generator]], torch.Tensor]
Activation = Callable[[torch.Tensor], torch.Tensor]


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


def time_encoder(num_freqs: int, features: int = 10,
                 generator: Optional[torch.Generator] = None) -> Tree:
  """modules.TimeEncoder: {'mlp'}, 6 x 64 with a skip at 4, a U[0, 0.05)
  logit."""
  dims = [encoding.posenc_output_dim(1, num_freqs)]
  return {'mlp': mlp(dims, 6, 64, (4,), output_channels=features,
                     generator=generator, output_init=uniform_init(0.05))}


def _depth(tree: Tree, prefix: str) -> int:
  return sum(1 for k in tree if k.startswith(prefix))


def apply_split_dense(params: Tree, inputs: Sequence[torch.Tensor],
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """concat(broadcast(inputs)) @ kernel + bias, without the broadcast.

  Each input's rows of the kernel make one term. A full-batch input of
  rank > 2 is flattened to 2-D for its product; a per-ray input
  (..., 1, C) broadcasts when the terms are added.
  """
  kernel = params['kernel']
  if dtype is not None:
    kernel = kernel.to(dtype)
    inputs = [x.to(dtype) for x in inputs]
  else:
    inputs = [x.to(torch.promote_types(x.dtype, kernel.dtype))
              for x in inputs]
  batch_shape = torch.broadcast_shapes(*[x.shape[:-1] for x in inputs])
  out, offset = None, 0
  for x in inputs:
    dim = x.shape[-1]
    block = kernel[offset:offset + dim].to(x.dtype)
    if x.shape[:-1] == batch_shape and x.dim() > 2:
      term = (x.reshape(-1, dim) @ block).reshape(*batch_shape, -1)
    else:
      term = x @ block
    out = term if out is None else out + term
    offset += dim
  if 'bias' in params:
    out = out + params['bias'].to(out.dtype)
  return out


def apply_mlp(params: Tree, inputs, skips: Sequence[int] = (),
              activation: Activation = torch.relu,
              output_activation: Optional[Activation] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """modules.MLP: 'hidden_i' layers, skips re-reading the inputs, and an
  optional 'logit' head. `inputs` is a tensor or a list of broadcastable
  ones; the depth is the tree's."""
  inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
  x = None
  for i in range(_depth(params, 'hidden_')):
    layer_inputs = (inputs if x is None
                    else ([x] + inputs if i in skips else [x]))
    x = activation(apply_split_dense(params[f'hidden_{i}'], layer_inputs,
                                     dtype))
  if 'logit' in params:
    x = apply_split_dense(params['logit'], inputs if x is None else [x],
                          dtype)
    if output_activation is not None:
      x = output_activation(x)
  return x


def apply_nerf_mlp(params: Tree, x: torch.Tensor,
                   trunk_condition: Optional[torch.Tensor],
                   alpha_condition: Optional[torch.Tensor],
                   rgb_condition: Optional[torch.Tensor],
                   skips: Sequence[int] = (4,),
                   activation: Activation = torch.relu,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
  """modules.NerfMLP on (B, S, C) points and per-ray (B, C) conditions.

  Returns {'rgb': (B, S, rgb_channels), 'alpha': (B, S, alpha_channels)},
  both float32.
  """
  def expand_ray(c):
    return c[..., None, :] if c is not None and c.dim() == x.dim() - 1 else c

  trunk_condition, alpha_condition, rgb_condition = map(
      expand_ray, (trunk_condition, alpha_condition, rgb_condition))
  trunk_inputs = [x] if trunk_condition is None else [x, trunk_condition]
  h = None
  for i in range(_depth(params, 'trunk_hidden_')):
    layer_inputs = trunk_inputs if h is None else (
        [h] + trunk_inputs if i in skips else [h])
    h = activation(apply_split_dense(params[f'trunk_hidden_{i}'],
                                     layer_inputs, dtype))
  bottleneck = (apply_split_dense(params['bottleneck'], [h], dtype)
                if 'bottleneck' in params else None)

  def branch(name, condition):
    inputs = [h] if condition is None else [bottleneck, condition]
    y = None
    for i in range(_depth(params, f'{name}_hidden_')):
      y = activation(apply_split_dense(params[f'{name}_hidden_{i}'],
                                       inputs if y is None else [y], dtype))
    return apply_split_dense(params[f'{name}_logit'],
                             inputs if y is None else [y],
                             dtype).to(torch.float32)

  return {'rgb': branch('rgb', rgb_condition),
          'alpha': branch('alpha', alpha_condition)}


def apply_time_encoder(params: Tree, time: torch.Tensor, num_freqs: int,
                       alpha=None) -> torch.Tensor:
  """modules.TimeEncoder: posenc of (..., 1) times, annealed by `alpha`
  (default num_freqs), through its MLP. float32: the module has no dtype."""
  if alpha is None:
    alpha = num_freqs
  encoded = encoding.posenc(time.to(torch.float32), num_freqs=num_freqs,
                            alpha=alpha)
  return apply_mlp(params['mlp'], encoded, skips=(4,))
