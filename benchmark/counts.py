"""Operations and bytes of the work, from a configuration's widths.

These count the work each operation needs, whatever implements it: the
products of the published layers (2 * rows * in * out a Dense layer), an
input that is constant along a ray (a GLO code, the rgb condition) taken
once a ray, each input read once and each output written once. A forward
that a kernel recomputes inside its backward is not counted; a backward
counts the products for dX and dW, twice the forward's. Elementwise work
(encodings, compositing, the SE(3) action) is not counted, as in the usual
model-FLOPs convention. A CPU test holds the forward counts to
`torch.utils.flop_counter.FlopCounterMode` over the reference.

Peaks: NVIDIA's data sheet for the SXM H100, dense, at its full 700 W.
"""

from typing import Dict, Optional

# name -> (dense bf16 FLOP/s, HBM bytes/s), by torch.cuda.get_device_name().
PEAKS = {
    'NVIDIA H100 80GB HBM3': (989e12, 3.35e12),
}

BF16, F32 = 2, 4
WARP_WIDTH, WARP_DEPTH, WARP_SKIPS, WARP_HEAD = 128, 6, (4,), 6


def peak(device_name: str) -> Optional[tuple]:
  return PEAKS.get(device_name)


def _posenc(channels: int, freqs: int) -> int:
  return channels * (2 * freqs + 1)


def condition_dims(model: Dict) -> int:
  dims = _posenc(3, model['num_nerf_viewdir_freqs'])
  if model['use_appearance_metadata'] and model['use_rgb_condition']:
    dims += model['appearance_metadata_dims']
  if model['use_camera_metadata']:
    dims += model['camera_metadata_dims']
  return dims


def nerf_layers(model: Dict):
  """(in, out) of each Dense product a sample makes in one NeRF level; the
  rgb layer's condition rows are a ray's (`nerf_ray_flops`)."""
  point = _posenc(3, model['num_nerf_point_freqs'])
  width = model['nerf_trunk_width']
  layers = []
  for i in range(model['nerf_trunk_depth']):
    layers.append((point if i == 0 else
                   width + point if i in model['nerf_skips'] else width,
                   width))
  layers += [(width, width), (width, model['alpha_channels'])]
  rgb_in = width
  for _ in range(model['nerf_rgb_branch_depth']):
    layers.append((rgb_in, model['nerf_rgb_branch_width']))
    rgb_in = model['nerf_rgb_branch_width']
  layers.append((rgb_in, model['rgb_channels']))
  return layers


def nerf_point_flops(model: Dict) -> float:
  """Forward FLOPs of one sample through one NeRF level's MLP."""
  return float(sum(2 * i * o for i, o in nerf_layers(model)))


def nerf_ray_flops(model: Dict) -> float:
  """Forward FLOPs of a ray's rgb condition through one level."""
  return 2.0 * condition_dims(model) * model['nerf_rgb_branch_width']


def warp_point_flops(model: Dict) -> float:
  """Forward FLOPs of one point through the SE(3) trunk and head (one
  tangent chain costs the same)."""
  pe = _posenc(3, model['num_warp_freqs'])
  total = 0
  for i in range(WARP_DEPTH):
    rows = pe if i == 0 else (WARP_WIDTH + pe if i in WARP_SKIPS
                              else WARP_WIDTH)
    total += 2 * rows * WARP_WIDTH
  return float(total + 2 * WARP_WIDTH * WARP_HEAD)


def warp_ray_flops(model: Dict) -> float:
  """Forward FLOPs of a ray's GLO code into layer 0 and each skip."""
  return 2.0 * model['num_warp_features'] * WARP_WIDTH * (1 + len(WARP_SKIPS))


def step_forward_flops(model: Dict, batch: int, bg_points: int) -> float:
  """Forward FLOPs of a train step: both levels, the coarse warp with its
  three tangent chains, the fine warp, the background points' warp."""
  coarse = model['num_coarse_samples']
  fine = coarse + model['num_fine_samples']
  nerf, warp = nerf_point_flops(model), warp_point_flops(model)
  per_ray = (coarse * (nerf + 4 * warp) + fine * (nerf + warp)
             + 2 * (nerf_ray_flops(model) + warp_ray_flops(model)))
  return batch * per_ray + bg_points * (warp + warp_ray_flops(model))


def step_flops(model: Dict, batch: int, bg_points: int) -> float:
  """Model FLOPs of a train step: the forward taken three times."""
  return 3.0 * step_forward_flops(model, batch, bg_points)


def render_ray_flops(model: Dict) -> float:
  """Forward FLOPs of one rendered ray: both levels with their warps."""
  samples = 2 * model['num_coarse_samples'] + model['num_fine_samples']
  return (samples * (nerf_point_flops(model) + warp_point_flops(model))
          + 2 * (nerf_ray_flops(model) + warp_ray_flops(model)))


def nerf_weight_bytes(model: Dict, dtype_bytes: int) -> float:
  layers = nerf_layers(model)
  return float(sum(i * o + o for i, o in layers) * dtype_bytes)


def nerf_forward_least_s(model: Dict, rows: int, device_name: str):
  """(least seconds, bound) of the serving NeRF forward over `rows`
  samples: bf16 encodings and rgb row biases in, four f32 outputs."""
  flops_peak, bw = PEAKS[device_name]
  point = _posenc(3, model['num_nerf_point_freqs'])
  flops = rows * nerf_point_flops(model)
  nbytes = (rows * (point * BF16 + model['nerf_rgb_branch_width'] * BF16
                    + 4 * F32) + nerf_weight_bytes(model, BF16))
  return _bound(flops / flops_peak, nbytes / bw)


def nerf_backward_least_s(model: Dict, rows: int, device_name: str):
  """(least seconds, bound) of the NeRF MLP backward over `rows` samples:
  dX and dW products; reads the bf16 inputs and row biases, the f32 output
  gradients and the weights, writes dX, the row biases' gradient and dW."""
  flops_peak, bw = PEAKS[device_name]
  point = _posenc(3, model['num_nerf_point_freqs'])
  rgb = model['nerf_rgb_branch_width']
  flops = 2.0 * rows * nerf_point_flops(model)
  nbytes = (rows * (point * BF16 + rgb * BF16 + 4 * F32 + point * F32
                    + rgb * F32)
            + nerf_weight_bytes(model, BF16) + nerf_weight_bytes(model, F32))
  return _bound(flops / flops_peak, nbytes / bw)


def _bound(compute_s: float, memory_s: float):
  if compute_s >= memory_s:
    return compute_s, 'compute'
  return memory_s, 'bytes'
