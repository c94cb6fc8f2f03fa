"""Host-side visualization: colormapped depth, accumulation and error maps.

Port of nerfies_tpu/visualization.py. The JAX module samples colormaps from
matplotlib; the port reads the same tables from `colormap_tables` (turbo,
magma and viridis, each a 256-colour ListedColormap in matplotlib), so it
needs no matplotlib.
"""

from typing import Optional

import numpy as np

from nerfies_tpu_torch import colormap_tables


def get_colormap(name: str, num_bins: int = 256) -> np.ndarray:
  """Returns an (num_bins, 3) float32 colormap table by matplotlib name.

  A ListedColormap of N colours maps x in [0, 1] to colour
  min(floor(x * N), N - 1), so sampling it at `num_bins` evenly spaced
  points picks those rows of its table, as matplotlib does.
  """
  if name not in colormap_tables.TABLES:
    raise ValueError(f'colormap {name!r} is not carried by the port; '
                     f'it has {sorted(colormap_tables.TABLES)}')
  table = colormap_tables.TABLES[name]
  n = table.shape[0]
  index = np.clip((np.linspace(0.0, 1.0, num_bins) * n).astype(np.int64),
                  0, n - 1)
  return table[index]


def interpolate_colormap(values: np.ndarray,
                         colormap: np.ndarray) -> np.ndarray:
  """Linearly interpolates a colormap table at `values` in [0, 1]."""
  num_bins = colormap.shape[0]
  positions = np.clip(values, 0.0, 1.0) * (num_bins - 1)
  lo = np.floor(positions).astype(np.int32)
  hi = np.minimum(lo + 1, num_bins - 1)
  frac = (positions - lo)[..., None]
  return (1.0 - frac) * colormap[lo] + frac * colormap[hi]


def scale_values(values: np.ndarray, vmin: float, vmax: float,
                 eps: float = 1e-6) -> np.ndarray:
  return (values - vmin) / max(vmax - vmin, eps)


def colorize(array: np.ndarray,
             cmin: Optional[float] = None,
             cmax: Optional[float] = None,
             cmap: str = 'magma',
             eps: float = 1e-6,
             invert: bool = False) -> np.ndarray:
  """Maps a scalar (H, W) array to an (H, W, 3) colormapped image."""
  array = np.asarray(array, np.float32)
  if cmin is None:
    cmin = float(array.min())
  if cmax is None:
    cmax = float(array.max())
  values = scale_values(array, cmin, cmax, eps)
  if invert:
    values = 1.0 - values
  return interpolate_colormap(values, get_colormap(cmap))


def colorize_binary_logits(array: np.ndarray,
                           cmap: Optional[str] = None) -> np.ndarray:
  """Colors per-pixel argmax over a logit stack (H, W, C) -> (H, W, 3)."""
  num_classes = array.shape[-1]
  if cmap is None:
    cmap = 'viridis' if num_classes <= 10 else 'turbo'
  indices = np.argmax(array, axis=-1).astype(np.float32)
  values = indices / max(num_classes - 1, 1)
  return interpolate_colormap(values, get_colormap(cmap))
