"""Traffic kind `render`: frames along an orbit through
`evaluation.render_camera` with `make_render_fn(model)` (the serving
kernels), each copied back before the next.

Set-up builds the render function and renders the mix's warm-up frames;
`check` compares frames drawn from the seed among the window's with the
reference's frames of the same cameras.
"""

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import cells
from benchmark import compare
from benchmark import scene
from benchmark import weights
from benchmark.reference import nerfies as reference


class Runner:
  """Frames of one configuration along the orbit of a render mix."""

  def __init__(self, cell, seed: int, place: cells.Place):
    self.cell, self.seed, self.place = cell, int(seed), place
    self.device = place.device
    self.model_cfg = cell.config['model']
    self.at_step = cell.config['at_step']
    self.chunk = cell.config['eval']['chunk']

  def setup(self) -> None:
    self.phases = phases = cells.Phases()
    from nerfies_tpu_torch import evaluation
    phases.mark('imports')
    self.ids = cells.num_ids(self.cell)
    self.params0 = weights.make(self.model_cfg, self.ids, self.seed,
                                self.device)
    phases.mark('weights', self.device)
    self.model = cells.build_model(self.cell, self.params0, False,
                                   use_stratified_sampling=False)
    self.render_fn = evaluation.make_render_fn(self.model,
                                               device=self.device)
    self.state = evaluation.RenderState(
        self.model.params, warp_alpha=self.at_step['warp_alpha'],
        time_alpha=self.at_step['time_alpha'])
    self.path = scene.render_path(self.cell.traffic, self.cell.config['scene'],
                                  self.cell.traffic['ids'], self.seed)
    self.frames: List = []
    phases.mark('model')
    for k in range(self.cell.traffic['warmup_frames']):
      self._one_frame()
      phases.mark(f'frame_{k + 1}', self.device)
    self.first_window = len(self.frames)

  def _one_frame(self):
    from nerfies_tpu_torch import evaluation
    index = len(self.frames)
    camera, ids = self.path[index % len(self.path)]
    out = evaluation.render_camera(self.state, camera, ids, self.render_fn,
                                   chunk=self.chunk)
    self.frames.append({k: out[k] for k in ('rgb', 'depth', 'acc')})
    return camera.width * camera.height

  def window(self, seconds: float) -> cells.Window:
    cells.sync(self.device)
    first = self.first_window
    start = time.perf_counter()
    deadline = start + seconds
    rays = 0
    while time.perf_counter() < deadline:
      rays += self._one_frame()
    elapsed = time.perf_counter() - start
    frames = self.frames[first:]
    self.window_frames = len(frames)
    failed = sum(1 for f in frames
                 if not all(np.isfinite(v).all() for v in f.values()))
    return cells.Window(len(frames), rays, elapsed, 0.0, failed)

  def stretch(self, frames: int = 2) -> int:
    for _ in range(frames):
      self._one_frame()
    return frames

  def release(self) -> None:
    for name in ('model', 'render_fn', 'state'):
      setattr(self, name, None)
    gc.collect()
    cells.free(self.device)

  def checked_frames(self) -> List[int]:
    """Frame indices compared, drawn from the seed among those of the
    window (each path position once)."""
    done = min(self.window_frames, len(self.path))
    rng = np.random.default_rng(self.seed)
    count = min(self.cell.traffic['checked_frames'], done)
    picks = rng.choice(done, size=count, replace=False)
    return sorted(self.first_window + int(i) for i in picks)

  def reference_frames(self, indices, precision: str = 'fp32'):
    """The reference's frames `indices` in `precision`."""
    ref = reference.Reference(self.model_cfg, self.cell.traffic['near'],
                              self.cell.traffic['far'], precision)
    block = self.cell.traffic['reference_rays']
    out = []
    with torch.no_grad(), reference.exact_matmuls():
      for index in indices:
        camera, ids = self.path[index % len(self.path)]
        directions = torch.from_numpy(
            camera.directions().reshape(-1, 3)).to(self.device)
        n = directions.shape[0]
        origins = torch.from_numpy(camera.position).to(self.device)
        parts = []
        for lo in range(0, n, block):
          d = directions[lo:lo + block]
          metadata = {k: torch.full((d.shape[0], 1), v, dtype=torch.int64,
                                    device=self.device)
                      for k, v in ids.items()}
          parts.append(ref.render(self.params0, origins.expand_as(d), d,
                                  metadata, self.at_step['warp_alpha']))
        h, w = camera.image_shape
        out.append({k: torch.cat([p[k] for p in parts]).reshape(
            h, w, *parts[0][k].shape[1:]).cpu().numpy()
                    for k in ('rgb', 'depth', 'acc')})
    return out

  def check(self) -> Dict[str, float]:
    indices = self.checked_frames()
    frames = self.reference_frames(indices)
    return compare.render_numbers([self.frames[i] for i in indices], frames)


def readings(cell, seed: int, control: bool, place: cells.Place,
             window_s: float):
  """[(mode, numbers)] of one seed, after a window of `window_s`: the
  program; with `control` also the reference in fp8 in its place."""
  run = Runner(cell, seed, place)
  run.setup()
  run.window(window_s)
  run.release()
  indices = run.checked_frames()
  ref = run.reference_frames(indices)
  out = [('program', compare.render_numbers(
      [run.frames[i] for i in indices], ref))]
  if control:
    out.append(('control', compare.render_numbers(
        run.reference_frames(indices, 'fp8'), ref)))
  return out


def end_to_end(windows) -> Dict[str, float]:
  """Pixels of every rank's frames over the longest rank's window."""
  return {'render_rays_per_s': sum(w.rays for w in windows)
                               / max(w.seconds for w in windows)}
