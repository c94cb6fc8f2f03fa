"""Positional encodings as batched functions.

Port of nerfies_tpu/ops/encoding.py. Feature order is the same: for C
input channels and F bands the output is [x?, sin(f0 x), cos(f0 x),
sin(f1 x), ...] in (F, 2, C) order, with cos written as sin(x + pi/2).
"""

import math
from typing import Optional

import torch


def freq_bands(num_freqs: int,
               min_freq_log2: float = 0.0,
               max_freq_log2: Optional[float] = None,
               dtype=torch.float32,
               device=None) -> torch.Tensor:
  """2^linspace(min, max, F) frequency bands."""
  if max_freq_log2 is None:
    max_freq_log2 = num_freqs - 1.0
  return 2.0 ** torch.linspace(min_freq_log2, max_freq_log2, int(num_freqs),
                               dtype=dtype, device=device)


def posenc(x: torch.Tensor,
           num_freqs: int,
           min_freq_log2: float = 0.0,
           max_freq_log2: Optional[float] = None,
           scale: float = 1.0,
           use_identity: bool = True,
           alpha=None) -> torch.Tensor:
  """Sinusoidal positional encoding with optional cosine-easing annealing.

  Args:
    x: (..., C) inputs.
    num_freqs: number of frequency octaves F.
    min_freq_log2 / max_freq_log2: band range (defaults 0 .. F-1).
    scale: multiplier on the angles.
    use_identity: prepend the raw input channels.
    alpha: optional annealing progress in [0, F] (float or 0-d tensor).

  Returns:
    (..., C + 2*F*C) if use_identity else (..., 2*F*C).
  """
  if num_freqs == 0:
    return x
  num_channels = x.shape[-1]
  freqs = freq_bands(num_freqs, min_freq_log2, max_freq_log2,
                     dtype=x.dtype, device=x.device)
  # (..., F, 1, C) angles; (..., F, 2, C) [sin, cos] branches.
  angles = scale * x[..., None, None, :] * freqs[:, None, None]
  features = torch.sin(torch.cat([angles, angles + 0.5 * math.pi], dim=-2))
  if alpha is not None:
    window = cosine_easing_window(num_freqs, alpha, min_freq_log2,
                                  max_freq_log2, device=x.device)
    features = features * window.to(x.dtype)[:, None, None]
  features = features.reshape(*x.shape[:-1], 2 * num_freqs * num_channels)
  if use_identity:
    return torch.cat([x, features], dim=-1)
  return features


def cosine_easing_window(num_freqs: int,
                         alpha,
                         min_freq_log2: float = 0.0,
                         max_freq_log2: Optional[float] = None,
                         device=None) -> torch.Tensor:
  """Per-band annealing weights 0.5 (1 + cos(pi clip(alpha - band, 0, 1) + pi)).

  Returns:
    (F,) float32 weights in [0, 1].
  """
  if max_freq_log2 is None:
    max_freq_log2 = num_freqs - 1.0
  bands = torch.linspace(min_freq_log2, max_freq_log2, num_freqs,
                         dtype=torch.float32, device=device)
  alpha = torch.as_tensor(alpha, dtype=torch.float32, device=bands.device)
  x = torch.clamp(alpha - bands, 0.0, 1.0)
  return 0.5 * (1.0 + torch.cos(math.pi * x + math.pi))


def posenc_output_dim(num_channels: int, num_freqs: int,
                      use_identity: bool = True) -> int:
  """Static output width of `posenc`."""
  if num_freqs == 0:
    return num_channels
  return num_channels * (2 * num_freqs + (1 if use_identity else 0))
