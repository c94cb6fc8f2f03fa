"""LPIPS perceptual distance in PyTorch.

Port of nerfies_tpu/lpips.py: the LPIPS computation graph (Zhang et al.
2018) over an AlexNet-style feature stack with ImageNet input
normalization, per-layer unit normalization across channels, squared
differences weighted by non-negative 1x1 taps, a spatial mean and a sum
over the five taps.

Weights load from the same .npz as the JAX module (`convert_torch_weights`
exports the official tensors on a machine with the `lpips` package; none
is fetched here, see docs/LPIPS.md). Without one the distance falls back
to the JAX module's seeded random-feature net, with the same numpy draws,
and reports as `lpips_uncal`.

The convolutions run in float64: on a CUDA tensor cuDNN computes float32
convolutions in TF32 by default, and a float64 one takes no TF32 path
whatever the program's settings.
"""

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nerfies_tpu_torch import resolve_device

# ImageNet statistics used by the official implementation's scaling layer
# (inputs in [-1, 1]).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature stack:
# (out_channels, kernel, stride, max_pool_before, padding).
# Padding is the torch AlexNet's explicit per-layer value, not 'SAME';
# calibrated weights only reproduce official LPIPS numbers with it.
_ALEX_LAYERS = (
    (64, 11, 4, False, 2),
    (192, 5, 1, True, 2),
    (384, 3, 1, True, 1),
    (256, 3, 1, False, 1),
    (256, 3, 1, False, 1),
)


def init_random_params(seed: int = 0) -> Dict[str, np.ndarray]:
  """He-normal conv stack + uniform linear taps (uncalibrated fallback)."""
  rng = np.random.RandomState(seed)
  params = {}
  in_ch = 3
  for i, (out_ch, k, _, _, _) in enumerate(_ALEX_LAYERS):
    fan_in = in_ch * k * k
    params[f'conv{i}_w'] = rng.normal(
        0.0, np.sqrt(2.0 / fan_in), (k, k, in_ch, out_ch)).astype(
            np.float32)
    params[f'conv{i}_b'] = np.zeros((out_ch,), np.float32)
    params[f'lin{i}_w'] = np.full((out_ch,), 1.0 / out_ch, np.float32)
    in_ch = out_ch
  params['calibrated'] = np.zeros((), np.bool_)
  return params


def load_params(weights_path) -> Dict[str, np.ndarray]:
  """Loads calibrated weights exported by `convert_torch_weights`."""
  data = np.load(weights_path)
  params = {k: data[k] for k in data.files}
  for i in range(len(_ALEX_LAYERS)):
    for key in (f'conv{i}_w', f'conv{i}_b', f'lin{i}_w'):
      if key not in params:
        raise ValueError(f'LPIPS weights file missing {key!r}')
  params['calibrated'] = np.ones((), np.bool_)
  return params


def convert_torch_weights(out_path) -> None:
  """Exports the official calibrated LPIPS-alex tensors to .npz.

  Run offline on a machine with the `lpips` package; the conv kernels
  (torch OIHW) transpose to HWIO and the 1x1 linear taps flatten to
  per-channel vectors, the layout both packages read.
  """
  import lpips as lpips_torch  # optional; never imported at eval time
  net = lpips_torch.LPIPS(net='alex')
  params = {}
  conv_idx = 0
  for slice_name in ('slice1', 'slice2', 'slice3', 'slice4', 'slice5'):
    for module in getattr(net.net, slice_name):
      if isinstance(module, torch.nn.Conv2d):
        params[f'conv{conv_idx}_w'] = (
            module.weight.detach().numpy().transpose(2, 3, 1, 0))
        params[f'conv{conv_idx}_b'] = module.bias.detach().numpy()
        conv_idx += 1
  for i, lin in enumerate(net.lins):
    params[f'lin{i}_w'] = (
        lin.model[-1].weight.detach().numpy().reshape(-1))
  np.savez(out_path, **params)


def _to_tensors(params, device) -> Dict[str, torch.Tensor]:
  """The numpy params as float64 tensors, conv kernels HWIO -> OIHW."""
  out = {}
  for i in range(len(_ALEX_LAYERS)):
    w = torch.from_numpy(np.asarray(params[f'conv{i}_w'], np.float64))
    out[f'conv{i}_w'] = w.permute(3, 2, 0, 1).contiguous().to(device)
    for key in (f'conv{i}_b', f'lin{i}_w'):
      out[key] = torch.from_numpy(
          np.asarray(params[key], np.float64)).to(device)
  return out


def _extract_features(weights, image: torch.Tensor) -> Sequence[torch.Tensor]:
  """The five relu feature taps (NCHW) for an NHWC image in [0, 1]."""
  shift = torch.as_tensor(_SHIFT, dtype=image.dtype, device=image.device)
  scale = torch.as_tensor(_SCALE, dtype=image.dtype, device=image.device)
  x = ((2.0 * image - 1.0) - shift) / scale
  x = x.permute(0, 3, 1, 2)
  feats = []
  for i, (_, _, stride, pool_before, pad) in enumerate(_ALEX_LAYERS):
    if pool_before:
      x = F.max_pool2d(x, kernel_size=3, stride=2)
    x = F.conv2d(x, weights[f'conv{i}_w'], stride=stride, padding=pad)
    x = torch.relu(x + weights[f'conv{i}_b'][:, None, None])
    feats.append(x)
  return feats


def _normalize_channels(feat: torch.Tensor, eps: float = 1e-10):
  norm = torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True))
  return feat / torch.clamp(norm, min=eps)


def _taps_nonempty(height: int, width: int) -> bool:
  """Whether every feature tap of an image this size has a pixel."""
  for _, k, stride, pool_before, pad in _ALEX_LAYERS:
    if pool_before:
      height, width = (height - 3) // 2 + 1, (width - 3) // 2 + 1
    height = (height + 2 * pad - k) // stride + 1
    width = (width + 2 * pad - k) // stride + 1
    if height <= 0 or width <= 0:
      return False
  return True


def lpips_distance(weights, image1: torch.Tensor,
                   image2: torch.Tensor) -> torch.Tensor:
  """LPIPS between (..., H, W, 3) images in [0, 1]; returns per-batch.

  `weights` are the tensors of `_to_tensors`, on the images' device and
  of their dtype. An image too small for a tap (under 31 pixels a side)
  gives NaN, as the JAX module's mean over the empty tap does.
  """
  squeeze = image1.ndim == 3
  if squeeze:
    image1, image2 = image1[None], image2[None]
  if not _taps_nonempty(image1.shape[1], image1.shape[2]):
    total = torch.full(image1.shape[:1], float('nan'), dtype=image1.dtype,
                       device=image1.device)
    return total[0] if squeeze else total
  total = 0.0
  feats1 = _extract_features(weights, image1)
  feats2 = _extract_features(weights, image2)
  for i, (f1, f2) in enumerate(zip(feats1, feats2)):
    diff = (_normalize_channels(f1) - _normalize_channels(f2)) ** 2
    weighted = diff * weights[f'lin{i}_w'][:, None, None]
    total = total + weighted.sum(dim=1).mean(dim=(1, 2))
  return total[0] if squeeze else total


class LPIPS:
  """Holds the params (numpy, as the JAX module) and their tensors on
  `device`; a call returns the distance of two images as a float."""

  def __init__(self, weights_path=None, seed: int = 0, device='cuda'):
    self.device = resolve_device(device)
    if weights_path is not None:
      self.params = load_params(weights_path)
      self.calibrated = True
    else:
      self.params = init_random_params(seed)
      self.calibrated = False
    self._weights = _to_tensors(self.params, self.device)

  @torch.no_grad()
  def __call__(self, image1, image2) -> float:
    as_tensor = lambda im: torch.as_tensor(
        np.asarray(im), dtype=torch.float64).to(self.device)
    return float(lpips_distance(self._weights, as_tensor(image1),
                                as_tensor(image2)))
