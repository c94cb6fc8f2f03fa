"""Full-image rendering for serving.

Port of `make_render_fn`, `render_camera` and `render_image`
(nerfies_tpu/evaluation.py:26-324), through the serving kernels or the
plain forward as JAX picks. The JAX package renders an image in
one jitted `lax.map` over chunks; here a Python loop over chunks queues
each chunk's work on the card's stream and fetches the outputs once at
the end. `render_camera` makes the rays on the device from the camera's
parameters (`camera.pixels_to_rays`); `render_image` takes rays built on
the host.

Under a process group (parallel/mesh.py) every rank renders its
contiguous 1/N of every chunk, drawing its rows of the chunk's draws,
and the image is gathered onto every rank, as JAX's sharded render
returns it replicated (nerfies_tpu/evaluation.py:186-192, 267-280); the
chunk is first rounded up to a multiple of N, as JAX rounds it to the
device count.

Under torch.profiler a frame is the range `render.frame`, and in it
`render.rays` (the camera's upload, each chunk's rays), `render.model`
(each chunk's model call) and `render.gather` (utils.span).
"""

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from nerfies_tpu_torch import camera as camera_lib
from nerfies_tpu_torch import fast_render
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.parallel import mesh


@dataclasses.dataclass
class RenderState:
  """What `render_image` reads of a train state: params and warp alphas."""
  params: Dict[str, Any]
  warp_alpha: float = 0.0
  time_alpha: float = 0.0

  @property
  def warp_extra(self) -> Dict[str, float]:
    return {'alpha': self.warp_alpha, 'time_alpha': self.time_alpha}


def make_render_fn(model, use_warp: bool = True, device='cuda',
                   fast: str = 'auto', occupancy=None,
                   keep_samples=None) -> Callable:
  """Builds the per-chunk render function.

  Returns a callable (params, rays_dict, warp_extra, generator=None) ->
  the model output dict for a flat ray batch, with the rays moved to
  `device` (the params must already lie there). Its `device` attribute
  names that device, and `stratified` whether it draws from `generator`.

  As in JAX (nerfies_tpu/evaluation.py:54-77), `fast='auto'` renders
  through the serving kernels (`fast_render.render_rays`) when the model
  samples deterministically and `fast_render.supported(model)` holds;
  otherwise, and always with `fast='off'`, through NerfModel.forward,
  which draws a stratified model's samples from `generator`.

  `occupancy` (an occupancy.OccupancyGrid baked from the model's density)
  with `keep_samples=(k_coarse, k_fine)` culls empty space on the serving
  path (`fast_render.render_rays`); the plain path ignores it.
  """
  device = resolve_device(device)
  if fast not in ('auto', 'off'):
    raise ValueError(f"fast must be 'auto' or 'off', not {fast!r}")
  use_fast = (fast == 'auto' and not model.use_stratified_sampling
              and fast_render.supported(model))

  def render_fn(params, rays_dict, warp_extra, generator=None):
    rays = utils.to_device(rays_dict, device)
    if use_fast:
      return fast_render.render_rays(params, rays, warp_extra, model,
                                     use_warp=use_warp, occupancy=occupancy,
                                     keep_samples=keep_samples)
    with torch.no_grad():
      return model(params, rays, warp_extra, use_warp=use_warp,
                   coarse_generator=generator, fine_generator=generator)

  render_fn.device = device
  render_fn.fast = use_fast
  render_fn.stratified = model.use_stratified_sampling
  return render_fn


def _chunk_generator(model_fn, seed: int, index: int):
  """A stratified render's stream for chunk `index`, folded from `seed`
  (`fold_in(rng, chunk)` in JAX), of which a rank draws its rows; None
  for a deterministic one."""
  if not model_fn.stratified:
    return None
  return mesh.shard_generator(utils.fold_in(seed, index, model_fn.device))


def _plan_chunks(num_rays: int, chunk: int, device_multiple: Optional[int]):
  """(chunk, rows of a chunk this rank renders, its first row there).

  The chunk is rounded up to a multiple of `device_multiple` (defaults
  to the world size) and capped at the padded image, as JAX plans it.

  Raises:
    ValueError: a chunk that does not divide by the world size.
  """
  world = mesh.world_size()
  if device_multiple is None:
    device_multiple = world
  chunk += mesh.pad_to_multiple(chunk, device_multiple)
  chunk = min(chunk, num_rays + mesh.pad_to_multiple(num_rays,
                                                     device_multiple))
  if chunk % world != 0:
    raise ValueError(
        f'Render chunk size {chunk} must be divisible by the process '
        f'count {world}; otherwise rays are silently dropped from every '
        'chunk.')
  per_rank = chunk // world
  return chunk, per_rank, mesh.rank() * per_rank


def _check_ret_key(default_ret_key):
  if default_ret_key not in (None, 'fine', 'coarse'):
    raise ValueError(f'default_ret_key must be fine or coarse, '
                     f'not {default_ret_key!r}')


@utils.spanned('render.gather')
def _gather_levels(level_outs, num_rays: int, h: int, w: int,
                   start: float) -> Dict[str, Any]:
  """The chunks' outputs as (H, W, ...) numpy maps, with the timings.

  Under a process group each chunk's output holds this rank's rows; the
  ranks' rows are gathered in one collective and put back in order.
  """
  keys = ('rgb', 'depth', 'med_depth', 'acc')
  local = {k: torch.cat([o[k] for o in level_outs]) for k in keys}
  world = mesh.world_size()
  if world > 1:
    flat = [local[k].reshape(local[k].shape[0], -1) for k in keys]
    rows = mesh.all_gather_rows(torch.cat(flat, dim=1))
    # (rank, chunk, row) -> (chunk, rank, row): the image's order.
    per_rank = level_outs[0][keys[0]].shape[0]
    rows = rows.reshape(world, len(level_outs), per_rank, -1).transpose(0, 1)
    rows = rows.reshape(world * len(level_outs) * per_rank, -1)
    columns = torch.split(rows, [t.shape[1] for t in flat], dim=1)
    local = {k: c.reshape(-1, *local[k].shape[1:])
             for k, c in zip(keys, columns)}
  result = {k: local[k][:num_rays].cpu().numpy() for k in keys}
  elapsed = time.perf_counter() - start
  result = {k: v.reshape((h, w, *v.shape[1:])) for k, v in result.items()}
  result['render_time'] = elapsed
  result['rays_per_sec'] = num_rays / max(elapsed, 1e-9)
  return result


@utils.spanned('render.frame')
def render_camera(state,
                  camera,
                  metadata_ids: Dict[str, Any],
                  model_fn: Callable,
                  chunk: int = 8192,
                  default_ret_key: Optional[str] = None,
                  seed: int = 0,
                  device_multiple: Optional[int] = None) -> Dict[str, Any]:
  """Renders a camera's full image with the rays made on the device.

  Only the camera parameters and the per-image metadata ids go to the
  device; each chunk's pixel centres come from an index over the rays and
  turn into world rays there (`camera.pixels_to_rays`). The last chunk is
  padded to the full chunk with copies of the last pixel, as
  `render_image` pads with the last ray, so every chunk has one shape.

  Args:
    state: anything with `.params` and `.warp_extra` (e.g. RenderState).
    camera: a camera.Camera (anything with .ray_parameters() and
      .image_shape).
    metadata_ids: scalar per-image ids, e.g. {'warp': 0, 'appearance': 0,
      'camera': 0, 'time': 0.3}; integers except 'time' (float32).
    model_fn: callable from `make_render_fn`.
    chunk / default_ret_key / seed / device_multiple: as `render_image`.

  Returns:
    Dict of (H, W, ...) numpy maps plus render_time / rays_per_sec.
  """
  _check_ret_key(default_ret_key)
  device = model_fn.device
  h, w = camera.image_shape
  num_rays = h * w
  chunk, rows, first = _plan_chunks(num_rays, chunk, device_multiple)
  with utils.span('render.rays'):
    cam = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
           for k, v in camera.ray_parameters().items()}

  start = time.perf_counter()
  level_outs = []
  for lo in range(0, num_rays, chunk):
    with utils.span('render.rays'):
      # Padding rays clamp to the last pixel.
      ray_idx = torch.clamp(
          torch.arange(lo + first, lo + first + rows, device=device),
          max=num_rays - 1)
      px = (ray_idx % w).float() + 0.5
      py = torch.div(ray_idx, w, rounding_mode='floor').float() + 0.5
      directions = camera_lib.pixels_to_rays(torch.stack([px, py], dim=-1),
                                             **cam)
      rays = {
          'origins': cam['position'].expand(rows, 3),
          'directions': directions,
          'metadata': {
              k: torch.full((rows, 1), v, device=device,
                            dtype=(torch.float32 if k == 'time'
                                   else torch.int64))
              for k, v in metadata_ids.items()},
      }
    with utils.span('render.model'):
      out = model_fn(state.params, rays, state.warp_extra,
                     _chunk_generator(model_fn, seed, lo // chunk))
    level = default_ret_key or ('fine' if 'fine' in out else 'coarse')
    level_outs.append(out[level])
  return _gather_levels(level_outs, num_rays, h, w, start)


@utils.spanned('render.frame')
def render_image(state,
                 rays_dict: Dict[str, Any],
                 model_fn: Callable,
                 chunk: int = 8192,
                 default_ret_key: Optional[str] = None,
                 seed: int = 0,
                 device_multiple: Optional[int] = None) -> Dict[str, Any]:
  """Renders every pixel of an image in fixed-size ray chunks.

  The last chunk is padded to the full chunk with copies of the last ray
  (edge padding), so every chunk has one shape; the padding is cut off.

  Args:
    state: anything with `.params` and `.warp_extra` (e.g. RenderState).
    rays_dict: (H, W, ...) numpy ray arrays (+ nested 'metadata').
    model_fn: callable from `make_render_fn`.
    chunk: rays per call; bounds peak activation memory.
    default_ret_key: 'fine' or 'coarse'; defaults to the finest level.
    seed: a stratified model's chunk i draws from fold_in(seed, i).
    device_multiple: round the chunk up to this multiple (defaults to the
      world size), as JAX's `device_multiple`.

  Returns:
    Dict of (H, W, ...) numpy maps rgb, depth, med_depth, acc, plus
    render_time (s, host clock, ending with the copy back) and rays_per_sec.

  Raises:
    ValueError: a chunk that does not divide by the world size.
  """
  _check_ret_key(default_ret_key)
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
      out[k] = part[first:first + rows]  # this rank's rows
    return out

  rays = flat(rays_dict)
  chunk, rows, first = _plan_chunks(num_rays, chunk, device_multiple)
  start = time.perf_counter()
  level_outs = []
  for lo in range(0, num_rays, chunk):
    with utils.span('render.rays'):
      chunk_rays = take(rays, lo, min(lo + chunk, num_rays))
    with utils.span('render.model'):
      out = model_fn(state.params, chunk_rays, state.warp_extra,
                     _chunk_generator(model_fn, seed, lo // chunk))
    level = default_ret_key or ('fine' if 'fine' in out else 'coarse')
    level_outs.append(out[level])
  return _gather_levels(level_outs, num_rays, h, w, start)
