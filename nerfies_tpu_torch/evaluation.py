"""Full-image rendering for serving.

Port of `make_render_fn` and `render_image` (nerfies_tpu/evaluation.py:26-152,
220-324). The JAX package renders an image in one jitted `lax.map` over
chunks; here a Python loop over chunks queues each chunk's work on the
card's stream and fetches the outputs once at the end. `render_camera`,
with its on-device ray generation, waits for a later slice.
"""

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from nerfies_tpu_torch import fast_render
from nerfies_tpu_torch import resolve_device


@dataclasses.dataclass
class RenderState:
  """What `render_image` reads of a train state: params and warp alphas."""
  params: Dict[str, Any]
  warp_alpha: float = 0.0
  time_alpha: float = 0.0

  @property
  def warp_extra(self) -> Dict[str, float]:
    return {'alpha': self.warp_alpha, 'time_alpha': self.time_alpha}


def _to_device(rays: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
  """Numpy or torch ray arrays -> tensors on `device`; ids become int64."""
  out = {}
  for key, value in rays.items():
    if isinstance(value, dict):
      out[key] = _to_device(value, device)
      continue
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(value).astype(
            np.int64 if np.issubdtype(np.asarray(value).dtype, np.integer)
            else np.float32))
    out[key] = t.to(device, non_blocking=True)
  return out


def make_render_fn(model, use_warp: bool = True,
                   device='cuda') -> Callable:
  """Builds the per-chunk render function.

  Returns a callable (params, rays_dict, warp_extra) -> the model output
  dict of `fast_render.render_rays` for a flat ray batch, with the rays
  moved to `device` (the params must already lie there).

  Raises:
    NotImplementedError: for a model the fast path does not cover (the
      JAX package falls back to `model.apply` there, which is not ported).
  """
  device = resolve_device(device)
  if model.use_stratified_sampling or not fast_render.supported(model):
    raise NotImplementedError(
        'only deterministic models that fast_render supports are served')

  def render_fn(params, rays_dict, warp_extra):
    return fast_render.render_rays(params, _to_device(rays_dict, device),
                                   warp_extra, model, use_warp=use_warp)

  return render_fn


def render_image(state,
                 rays_dict: Dict[str, Any],
                 model_fn: Callable,
                 chunk: int = 8192,
                 default_ret_key: Optional[str] = None) -> Dict[str, Any]:
  """Renders every pixel of an image in fixed-size ray chunks.

  The last chunk is padded to the full chunk with copies of the last ray
  (edge padding), so every chunk has one shape; the padding is cut off.

  Args:
    state: anything with `.params` and `.warp_extra` (e.g. RenderState).
    rays_dict: (H, W, ...) numpy ray arrays (+ nested 'metadata').
    model_fn: callable from `make_render_fn`.
    chunk: rays per call; bounds peak activation memory.
    default_ret_key: 'fine' or 'coarse'; defaults to the finest level.

  Returns:
    Dict of (H, W, ...) numpy maps rgb, depth, med_depth, acc, plus
    render_time (s, host clock, ending with the copy back) and rays_per_sec.
  """
  if default_ret_key not in (None, 'fine', 'coarse'):
    raise ValueError(f'default_ret_key must be fine or coarse, '
                     f'not {default_ret_key!r}')
  h, w = rays_dict['origins'].shape[:2]
  num_rays = h * w

  def flat(tree):
    return {k: (flat(v) if isinstance(v, dict)
                else np.asarray(v).reshape(num_rays, np.shape(v)[-1]))
            for k, v in tree.items()}

  def take(tree, lo, hi):
    out = {}
    for k, v in tree.items():
      if isinstance(v, dict):
        out[k] = take(v, lo, hi)
        continue
      part = v[lo:hi]
      if hi - lo < chunk:
        part = np.pad(part, ((0, chunk - (hi - lo)), (0, 0)), mode='edge')
      out[k] = part
    return out

  rays = flat(rays_dict)
  chunk = min(chunk, num_rays)
  start = time.perf_counter()
  level_outs = []
  for lo in range(0, num_rays, chunk):
    hi = min(lo + chunk, num_rays)
    out = model_fn(state.params, take(rays, lo, hi), state.warp_extra)
    level = default_ret_key or ('fine' if 'fine' in out else 'coarse')
    level_outs.append(out[level])
  keys = ('rgb', 'depth', 'med_depth', 'acc')
  result = {k: torch.cat([o[k] for o in level_outs])[:num_rays].cpu().numpy()
            for k in keys}
  elapsed = time.perf_counter() - start
  result = {k: v.reshape((h, w, *v.shape[1:])) for k, v in result.items()}
  result['render_time'] = elapsed
  result['rays_per_sec'] = num_rays / max(elapsed, 1e-9)
  return result
