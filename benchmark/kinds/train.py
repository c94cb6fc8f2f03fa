"""Traffic kind `train`: `training.make_train_step`'s step, back to back, each
batch drawn by the port's `iterator_from_pool` (shuffled, prefetching) from
a `RayPool` of the capture and background points from
`iterator_from_arrays`, as the training CLI feeds it.

Set-up builds one step object and drives it through the mix's first steps
with the window's own call and feed; the first `checked_steps` of them are
what `check` compares with the reference once the window has closed and
the program's state is freed. The batches they were fed are first held to
the capture, made again from the seed: every row has to be a pixel of it.
"""

import gc
import time
from typing import Dict

import torch

from benchmark import cells
from benchmark import compare
from benchmark import scene
from benchmark import weights
from benchmark.reference import nerfies as reference


class Runner:
  """Training steps of one configuration on the capture of a train mix."""

  def __init__(self, cell, seed: int, place: cells.Place):
    self.cell, self.seed, self.place = cell, int(seed), place
    self.device = place.device
    self.model_cfg = cell.config['model']
    self.train_cfg = cell.config['train']
    self.at_step = cell.config['at_step']
    self.checked = cell.traffic['checked_steps']

  def setup(self) -> None:
    self.phases = phases = cells.Phases()
    from nerfies_tpu_torch import configs
    from nerfies_tpu_torch import training
    from nerfies_tpu_torch.datasets import core
    phases.mark('imports')
    cell, tc = self.cell, self.train_cfg
    self.ids = cells.num_ids(cell)
    self.params0 = weights.make(self.model_cfg, self.ids, self.seed,
                                self.device)
    phases.mark('weights', self.device)
    self.model = cells.build_model(cell, self.params0, tc['use_elastic_loss'])
    train_config = configs.TrainConfig(**tc)
    self.step = training.make_train_step(self.model, train_config,
                                         self.device)
    self.scalars = training.ScalarParams(
        learning_rate=self.at_step['learning_rate'],
        elastic_loss_weight=self.at_step['elastic_loss_weight'],
        background_loss_weight=tc['background_loss_weight'],
        background_noise_std=self.at_step['background_noise_std'])
    self.state = training.create_train_state(
        self.model.params, warp_alpha=self.at_step['warp_alpha'],
        time_alpha=self.at_step['time_alpha'])
    phases.mark('model')
    capture = scene.capture(cell.traffic, cell.config['scene'], self.ids,
                            self.seed)
    phases.mark('capture')
    pool = core.RayPool(capture.directions, capture.rgb, capture.image_idx,
                        capture.origins, capture.metadata)
    prefetch = cell.traffic['prefetch']
    self.rays = core.iterator_from_pool(
        pool, tc['batch_size'], seed=self.seed, shuffle=True,
        prefetch_size=prefetch)
    self.points = core.iterator_from_arrays(
        capture.points, batch_size=tc['background_points_batch_size'],
        shuffle=True, seed=self.seed, prefetch_size=prefetch)
    self.batches, self.losses, self.window_losses = [], [], []
    self.first_grads = self.params3 = None
    self.done = 0
    phases.mark('pipeline')
    for k in range(cell.traffic['warmup_steps']):
      self._one_step()
      phases.mark(f'step_{k + 1}', self.device)

  def _next_batch(self):
    batch = next(self.rays)
    batch['background_points'] = next(self.points)
    return batch

  def _one_step(self) -> float:
    start = time.perf_counter()
    batch = self._next_batch()
    waited = time.perf_counter() - start
    self.done += 1
    self.state, stats = self.step(
        cells.step_generator(self.seed, self.done, self.device), self.state,
        batch, self.scalars)
    if self.done <= self.checked:
      self.batches.append(batch)
      self.losses.append(stats)
      if self.done == 1:
        self.first_grads = {k: v.detach() / 0.1 for k, v in
                            weights.flatten(self.state.opt_state.mu).items()}
      if self.done == self.checked:
        self.params3 = {k: v.detach().clone() for k, v in
                        weights.flatten(self.state.params).items()}
    else:
      self.window_losses.append(stats['fine']['loss/rgb'])
    return waited

  def window(self, seconds: float) -> cells.Window:
    self.window_losses = []
    cells.sync(self.device)
    start = time.perf_counter()
    deadline = start + seconds
    waited, steps = 0.0, 0
    while time.perf_counter() < deadline:
      waited += self._one_step()
      steps += 1
    cells.sync(self.device)
    elapsed = time.perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(self.window_losses))).sum())
    return cells.Window(steps, steps * self.train_cfg['batch_size'],
                        elapsed, waited, failed)

  def stretch(self, steps: int = 3) -> int:
    self.window_losses = []
    for _ in range(steps):
      self._one_step()
    return steps

  def release(self) -> None:
    """Frees the program's state, keeping the checked steps' outputs."""
    self.losses = [_total_loss(s, self.scalars) for s in self.losses]
    for name in ('model', 'step', 'state', 'rays', 'points'):
      setattr(self, name, None)
    gc.collect()
    cells.free(self.device)

  def reference_readings(self, precision: str = 'fp32'):
    """The reference's (losses, first gradients, params after the checked
    steps) in `precision`, from the weights, batches and streams the
    program was handed."""
    ref = reference.Reference(self.model_cfg, self.cell.traffic['near'],
                              self.cell.traffic['far'], precision)
    scalars = dict(self.at_step,
                   background_loss_weight=self.train_cfg[
                       'background_loss_weight'],
                   num_warp_ids=self.ids['warp'])
    samples = (self.model_cfg['num_coarse_samples']
               + self.model_cfg['num_fine_samples'])
    block = max(1, self.cell.traffic['reference_points'] // samples)
    batches = [cells.tensors(b, self.device) for b in self.batches]
    generators = [cells.step_generator(self.seed, k + 1, self.device)
                  for k in range(len(batches))]
    with reference.exact_matmuls():
      losses, grads, params = reference.train_steps(
          ref, self.params0, batches, generators, scalars, block)
    return losses, grads, params

  def program_readings(self):
    return self.losses, self.first_grads, self.params3

  def rows_off(self) -> int:
    """Rows of the checked batches that are no pixel (or background point)
    of the capture, made again from the seed."""
    capture = scene.capture(self.cell.traffic, self.cell.config['scene'],
                            self.ids, self.seed)
    return compare.rows_off(self.batches, capture)

  def check(self) -> Dict[str, float]:
    numbers = compare.train_numbers(
        self.program_readings(), self.reference_readings(),
        weights.flatten(self.params0))
    numbers['rows_off'] = float(self.rows_off())
    return numbers


def _total_loss(stats, scalars) -> float:
  total = float(stats['fine']['loss/total']) + float(
      stats['coarse']['loss/total'])
  if 'background_loss' in stats:
    total += scalars.background_loss_weight * float(stats['background_loss'])
  return total


def _half(batch):
  out = {}
  for key, value in batch.items():
    if key == 'background_points':
      out[key] = value
    elif isinstance(value, dict):
      out[key] = _half(value)
    else:
      out[key] = value[:len(value) // 2]
  return out


def half_batch_steps():
  """Patches training.make_train_step so that each step sees the first half
  of its batch, the mean taken over it; returns the undo."""
  from nerfies_tpu_torch import training
  original = training.make_train_step

  def make(*args, **kwargs):
    step = original(*args, **kwargs)
    return lambda g, state, batch, scalars, **kw: step(
        g, state, _half(batch), scalars, **kw)

  training.make_train_step = make
  return lambda: setattr(training, 'make_train_step', original)


def misrouted_rows():
  """Patches RayPool.assemble so that each batch pairs its rgb with the
  next row's ray, as a pipeline fault would; returns the undo."""
  import numpy as np
  from nerfies_tpu_torch.datasets import core
  original = core.RayPool.assemble

  def assemble(self, indices):
    batch = original(self, indices)
    batch['rgb'] = np.roll(batch['rgb'], 1, axis=0)
    return batch

  core.RayPool.assemble = assemble
  return lambda: setattr(core.RayPool, 'assemble', original)


def _faulty(cell, seed: int, place: cells.Place, patch):
  undo = patch()
  try:
    run = Runner(cell, seed, place)
    run.setup()
    run.release()
  finally:
    undo()
  return run


def readings(cell, seed: int, control: bool, place: cells.Place,
             window_s: float):
  """[(mode, numbers)] of one seed: the program; with `control` also the
  reference in fp8 in the program's place, half of each batch, and rows
  misrouted by the pipeline."""
  del window_s  # training's readings need no window
  run = Runner(cell, seed, place)
  run.setup()
  run.release()
  params0 = weights.flatten(run.params0)
  ref = run.reference_readings('fp32')
  program = compare.train_numbers(run.program_readings(), ref, params0)
  out = [('program', dict(program, rows_off=float(run.rows_off())))]
  if control:
    out.append(('control', compare.train_numbers(
        run.reference_readings('fp8'), ref, params0)))
    half = _faulty(cell, seed, place, half_batch_steps)
    out.append(('half_batch', compare.train_numbers(
        half.program_readings(), ref, params0)))
    misrouted = _faulty(cell, seed, place, misrouted_rows)
    out.append(('misrouted_rows', {'rows_off': float(misrouted.rows_off())}))
  return out


def end_to_end(windows) -> Dict[str, float]:
  """Rays of every rank's steps over the longest rank's window."""
  return {'train_rays_per_s': sum(w.rays for w in windows)
                              / max(w.seconds for w in windows)}
