"""SSIM and multi-scale SSIM in PyTorch.

Port of nerfies_tpu/ops/ssim.py: an 11x11 gaussian window of sigma 1.5,
applied separably as two grouped 'valid' convolutions, the standard power
weights and an edge-padded 2x average pool between scales, the semantics
of tf.image.ssim_multiscale.

Everything runs in float64. The variance terms are E[x^2] - mu^2, a
cancellation that sits near 1e-6 on smooth, low-variance images; the JAX
module records that bf16 convolution inputs drove it negative there and
gave SSIM values of 7.2 and 21.4 (nerfies_tpu/ops/ssim.py:37-44). On a
CUDA tensor cuDNN computes float32 convolutions in TF32 by default, with
a 10-bit mantissa: the same hazard. A float64 convolution takes no TF32
path and leaves the program's TF32 settings as they are.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Power weights from Wang et al. (2003), as used by tf.image.ssim_multiscale.
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _as_image(img) -> torch.Tensor:
  """An (H, W, C) numpy array or tensor as a float64 tensor (same device)."""
  if not isinstance(img, torch.Tensor):
    img = torch.from_numpy(np.asarray(img))
  return img.to(torch.float64)


def _fspecial_gauss(size: int, sigma: float, device) -> torch.Tensor:
  """1-D gaussian window (separable filtering)."""
  coords = (torch.arange(size, dtype=torch.float64, device=device)
            - (size - 1.0) / 2.0)
  g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
  return g / g.sum()


def _filter2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
  """Separable 'valid' convolution over (H, W, C) images."""
  size = window.shape[0]
  channels = img.shape[-1]
  x = img.permute(2, 0, 1)[None]  # (1, C, H, W)
  x = F.conv2d(x, window.reshape(1, 1, size, 1).expand(channels, 1, size, 1),
               groups=channels)
  x = F.conv2d(x, window.reshape(1, 1, 1, size).expand(channels, 1, 1, size),
               groups=channels)
  return x[0].permute(1, 2, 0)


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         return_cs: bool = False):
  """SSIM between two (H, W, C) images.

  Returns the mean SSIM (and the mean contrast-structure term if
  return_cs) as 0-dim float64 tensors.
  """
  img0, img1 = _as_image(img0), _as_image(img1)
  window = _fspecial_gauss(filter_size, filter_sigma, img0.device)
  c1 = (k1 * max_val) ** 2
  c2 = (k2 * max_val) ** 2

  mu0 = _filter2d(img0, window)
  mu1 = _filter2d(img1, window)
  mu00 = mu0 * mu0
  mu11 = mu1 * mu1
  mu01 = mu0 * mu1
  sigma00 = _filter2d(img0 * img0, window) - mu00
  sigma11 = _filter2d(img1 * img1, window) - mu11
  sigma01 = _filter2d(img0 * img1, window) - mu01

  cs = (2.0 * sigma01 + c2) / (sigma00 + sigma11 + c2)
  luminance = (2.0 * mu01 + c1) / (mu00 + mu11 + c1)
  ssim_map = luminance * cs
  if return_cs:
    return ssim_map.mean(), cs.mean()
  return ssim_map.mean()


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
  """2x2 average pooling with stride 2 (pads odd dims like tf)."""
  h, w, _ = img.shape
  x = img.permute(2, 0, 1)[None]
  if h % 2 or w % 2:
    x = F.pad(x, (0, w % 2, 0, h % 2), mode='replicate')
  return F.avg_pool2d(x, 2, 2)[0].permute(1, 2, 0)


def max_feasible_scales(height: int, width: int,
                        filter_size: int = 11) -> int:
  """Largest number of MS-SSIM scales the image size supports.

  Each scale halves the image (ceil), and the 'valid' gaussian filtering
  needs at least `filter_size` pixels per side at the coarsest scale.
  """
  scales = 0
  side = min(height, width)
  while side >= filter_size and scales < len(MSSSIM_WEIGHTS):
    scales += 1
    side = (side + 1) // 2
  return scales


def multiscale_ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
                    filter_sigma: float = 1.5, k1: float = 0.01,
                    k2: float = 0.03,
                    weights: Tuple[float, ...] = MSSSIM_WEIGHTS
                    ) -> torch.Tensor:
  """Multi-scale SSIM between two (H, W, C) images in [0, max_val].

  The contrast-structure term at every scale but the last, full SSIM at
  the coarsest, combined by power weights (tf.image.ssim_multiscale).
  Images must be at least filter_size * 2**(len(weights)-1) on each side.
  Returns a 0-dim float64 tensor on the images' device.
  """
  im0, im1 = _as_image(img0), _as_image(img1)
  weights = torch.as_tensor(weights, dtype=torch.float64, device=im0.device)
  num_scales = weights.shape[0]
  values = []
  for scale in range(num_scales):
    if scale == num_scales - 1:
      mean_ssim = ssim(im0, im1, max_val, filter_size, filter_sigma, k1, k2)
      values.append(torch.clamp(mean_ssim, min=0.0))
    else:
      _, mean_cs = ssim(im0, im1, max_val, filter_size, filter_sigma, k1, k2,
                        return_cs=True)
      values.append(torch.clamp(mean_cs, min=0.0))
      im0, im1 = _avg_pool2(im0), _avg_pool2(im1)
  return torch.prod(torch.stack(values) ** weights)
