#!/usr/bin/env python3
"""The port's training over several seeds on a workload the CPU can run.

Trains the plain float32 route (`NerfModel.forward`, no kernel) of the
quality bench's model, narrowed, on the quality bench's textured scene at
96x72, on JAX's quality schedules scaled by 3,000 / 6,000: the run stops
at step 3,000 of a 10,000-step schedule, so the warp window passes alpha
1.0 at step 1,667 and reaches 1.8, as JAX's 6,000-step curve does. Every
EVAL_EVERY steps it renders the first val view and the first train view
and writes a curve row (the quality bench's keys, plus the mean train
loss over the steps since the last row). One JSON curve per seed:

  python3 scripts/training_spread_torch.py --device cpu --seeds 0 1 \\
      --out_dir nerfies_tpu_torch/curves/spread
  python3 scripts/training_spread_torch.py --seeds 0 1 2 3 \\
      --out_dir nerfies_tpu_torch/curves/spread      # on the card

scripts/training_spread_jax.py trains the same workload with the JAX
package on the CPU and takes its constants from this module;
scripts/compare_quality_curves.py --spread compares two sets of curves.

Seed s draws the params from torch seed 2s, the steps' draws from
`training.step_generator(2s + 1, step)`, and shuffles the rays and the
background points with s (the data order of JAX's run of the same seed).
For a bisection of a gap between the two packages:
  --init_npz PATH  starts from the params of training_spread_jax.py
                   --save_init (JAX's init of that seed);
  --numpy_draws    replaces every draw of the step (`parallel.mesh.draw`)
                   by numpy's, from a generator seeded by (seed, step).
Imports no JAX.
"""

import argparse
import dataclasses
import functools
import json
import pathlib
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
# Run as a script, its own folder leads sys.path, and scripts/profile.py
# there would shadow the standard library's `profile`.
sys.path[:] = [str(REPO)] + [
    p for p in sys.path if pathlib.Path(p or '.').resolve() != REPO / 'scripts']

from nerfies_tpu_torch import configs  # pylint: disable=g-import-not-at-top
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import core as datasets_core
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.parallel import mesh

# The scene: the quality bench's (scripts/quality_bench.py), at 96x72.
SCENE = dict(num_train=24, num_val=2, image_size=(96, 72),
             motion_amplitude=0.15, texture_frequency=20.0,
             cameras_per_state=2, env_background=True, num_points=16384)
# The model: the bench model (configs.bench_train_config, bench.py's
# model_config) with a 4x128 trunk, a skip at layer 2 and 32 + 32 samples,
# in float32 through the plain forward; rgb padding as the quality bench.
MODEL_FIELDS = dict(nerf_trunk_depth=4, nerf_trunk_width=128,
                    nerf_skips=(2,), num_coarse_samples=32,
                    num_fine_samples=32, use_bfloat16=False,
                    use_fused_mlp=False, use_fused_warp=False,
                    rgb_padding=0.001)
# The narrower model of the trained state that tests/data holds (a file
# well under 1 MB: params and both Adam moments).
STATE_MODEL_FIELDS = dict(MODEL_FIELDS, nerf_trunk_width=32,
                          nerf_rgb_branch_width=32,
                          warp_kwargs={'trunk_depth': 4, 'trunk_width': 64,
                                       'skips': (2,)})
BATCH_SIZE = 256
BACKGROUND_POINTS = 16384
# JAX's quality run: 20,000-step schedules read to step 6,000; here both
# halved.
SCHEDULE_STEPS = 10000
STOP_AT = 3000
EVAL_EVERY = 500
LR_SCHEDULE = ('exponential', 1e-3, 1e-4, SCHEDULE_STEPS)
ELASTIC_WEIGHT = 1e-3
BACKGROUND_WEIGHT = 1.0
EVAL_CHUNK = 4096
SCENE_DIR = str(pathlib.Path(quality_bench.DEFAULT_DIR) / 'spread_scene')
# Rays and background points of the batch that tests/data keeps.
STATE_BATCH_RAYS = 32
STATE_BATCH_POINTS = 64


def params_seed(seed: int) -> int:
  return 2 * seed


def step_seed(seed: int) -> int:
  return 2 * seed + 1


def warp_alpha_schedule(num_warp_freqs: int):
  return ('linear', 0.0, num_warp_freqs, SCHEDULE_STEPS)


def model_config(fields: Optional[Dict[str, Any]] = None
                 ) -> configs.ModelConfig:
  model, _ = configs.bench_train_config()
  return dataclasses.replace(model, **(fields or MODEL_FIELDS))


def write_scene(scene_dir) -> pathlib.Path:
  """The scene, written once."""
  scene = pathlib.Path(scene_dir)
  if not (scene / 'dataset.json').exists():
    synthetic.write_synthetic_dataset(scene, **SCENE)
  return scene


def load_datasource(scene, seed: int):
  return datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)}, image_scale=1,
      use_appearance_id=True, use_camera_id=True, use_warp_id=True,
      random_seed=seed)


class NumpyDraws:
  """`parallel.mesh.draw` drawing from numpy: uniforms for torch.rand,
  normals for torch.randn and integers for a torch.randint with its bound
  bound, from a generator that `reseed(seed, step)` sets each step."""

  def __init__(self):
    self.rng = np.random.default_rng(0)

  def reseed(self, seed: int, step: int) -> None:
    self.rng = np.random.default_rng([seed, step])

  def __call__(self, fn, shape, generator, **kwargs):
    del generator
    device = kwargs.get('device')
    if fn is torch.rand:
      array = self.rng.random(shape, dtype=np.float32)
    elif fn is torch.randn:
      array = self.rng.standard_normal(shape, dtype=np.float32)
    elif isinstance(fn, functools.partial) and fn.func is torch.randint:
      array = self.rng.integers(0, fn.args[0], shape)
    else:
      raise TypeError(f'No numpy draw for {fn!r}')
    out = torch.from_numpy(array).to(device)
    return out.to(kwargs['dtype']) if 'dtype' in kwargs else out


def run(seed: int, device, scene_dir, out_path=None,
        init_npz: Optional[str] = None, numpy_draws: bool = False,
        stop_at: int = STOP_AT, eval_every: int = EVAL_EVERY
        ) -> Dict[str, Any]:
  """Trains one seed; returns the curve (and writes it to `out_path`)."""
  device = resolve_device(device)
  scene = write_scene(scene_dir)
  datasource = load_datasource(scene, seed)
  config = model_config()
  ids = dict(appearance_ids=datasource.appearance_ids,
             camera_ids=datasource.camera_ids,
             warp_ids=datasource.warp_ids,
             near=datasource.near, far=datasource.far)
  _, bench_train = configs.bench_train_config()
  train_config = dataclasses.replace(
      bench_train, batch_size=BATCH_SIZE,
      background_points_batch_size=BACKGROUND_POINTS)
  model, params = nerf.construct_nerf(
      config, generator=torch.Generator().manual_seed(params_seed(seed)),
      device=device, use_warp_jacobian=True, use_weights=True, **ids)
  if init_npz:
    params = interop.params_from_jax(interop.load_npz_tree(init_npz),
                                     device)
  step_fn = training.make_train_step(model, train_config, device)
  state = training.create_train_state(params)

  lr_sched = schedules.from_config(LR_SCHEDULE)
  warp_alpha_sched = schedules.from_config(
      warp_alpha_schedule(config.num_warp_freqs))
  train_iter = datasource.create_iterator(
      datasource.train_ids, flatten=True, shuffle=True,
      batch_size=BATCH_SIZE, prefetch_size=3)
  points = datasource.load_points(shuffle=True)
  points_iter = datasets_core.iterator_from_arrays(
      points, batch_size=min(len(points), BACKGROUND_POINTS), shuffle=True,
      seed=seed, prefetch_size=3)

  eval_model, _ = nerf.construct_nerf(
      dataclasses.replace(config, use_stratified_sampling=False),
      device=device, **ids)
  render_fn = evaluation.make_render_fn(eval_model, device=device,
                                        fast='off')
  val_rays, val_rgb = quality_bench.load_view(datasource,
                                              datasource.val_ids[0])
  train_rays, train_rgb = quality_bench.load_view(datasource,
                                                  datasource.train_ids[0])
  card = quality_bench.card_label() if device.type == 'cuda' else None
  result = {
      'package': 'nerfies_tpu_torch',
      'route': 'plain float32',
      'seed': seed,
      'device': (torch.cuda.get_device_name(device)
                 if device.type == 'cuda' else 'cpu'),
      'init': 'jax' if init_npz else 'torch',
      'draws': 'numpy' if numpy_draws else 'torch',
      'image_size': list(SCENE['image_size']),
      'batch_size': BATCH_SIZE,
      'steps': SCHEDULE_STEPS,
      'curve': [],
  }
  if card is not None:
    result['card'], result['power_limit'] = card
  if stop_at < SCHEDULE_STEPS:
    result['partial'] = True

  draws = NumpyDraws()
  real_draw = mesh.draw
  if numpy_draws:
    mesh.draw = draws
  losses = []
  t_start = time.time()
  try:
    for step in range(1, stop_at + 1):
      batch = next(train_iter)
      batch['background_points'] = next(points_iter)
      scalar_params = training.ScalarParams(
          learning_rate=lr_sched(step), elastic_loss_weight=ELASTIC_WEIGHT,
          background_loss_weight=BACKGROUND_WEIGHT)
      state = dataclasses.replace(state,
                                  warp_alpha=float(warp_alpha_sched(step)))
      draws.reseed(step_seed(seed), step)
      state, stats = step_fn(
          training.step_generator(step_seed(seed), step, device), state,
          batch, scalar_params)
      losses.append(float(stats['fine']['loss/rgb']))
      if step % eval_every == 0 or step == stop_at:
        if not np.isfinite(losses[-1]):
          raise FloatingPointError(f'step {step}: loss {losses[-1]}')
        with torch.no_grad():
          val = evaluation.render_image(state, val_rays, render_fn,
                                        chunk=EVAL_CHUNK)
          train_view = evaluation.render_image(state, train_rays, render_fn,
                                               chunk=EVAL_CHUNK)
        result['curve'].append({
            'step': step,
            'val_psnr': quality_bench.psnr(np.clip(val['rgb'], 0, 1),
                                           val_rgb),
            'train_view_psnr': quality_bench.psnr(
                np.clip(train_view['rgb'], 0, 1), train_rgb),
            'train_loss': losses[-1],
            'train_loss_mean': float(np.mean(losses)),
            'warp_alpha': float(warp_alpha_sched(step)),
            'wall_s': time.time() - t_start})
        losses = []
        print(json.dumps(result['curve'][-1]), flush=True)
        if out_path:
          write_curve(out_path, result)
  finally:
    mesh.draw = real_draw
  return result


def write_curve(path, result) -> None:
  path = pathlib.Path(path)
  path.parent.mkdir(parents=True, exist_ok=True)
  path.write_text(json.dumps(result, indent=1, allow_nan=False))


def curve_name(package: str, device: str, seed: int, tag: str = '') -> str:
  return f'spread_{package}_{device}{tag}_seed{seed}.json'


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seeds', type=int, nargs='+', default=[0])
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs without a card")
  parser.add_argument('--scene_dir', default=SCENE_DIR,
                      help='the scene, written there once')
  parser.add_argument('--out_dir', default='nerfies_tpu_torch/curves/spread')
  parser.add_argument('--stop_at', type=int, default=STOP_AT)
  parser.add_argument('--eval_every', type=int, default=EVAL_EVERY)
  parser.add_argument('--init_npz', default='',
                      help="start from these params (training_spread_jax.py "
                      "--save_init's npz, JAX's init of the seed)")
  parser.add_argument('--numpy_draws', action='store_true',
                      help='draw every random number of the step from numpy')
  parser.add_argument('--threads', type=int, default=0,
                      help='torch intra-op threads on the CPU (0: default)')
  parser.add_argument('--tag', default='',
                      help='a suffix of the device in the curve file names')
  args = parser.parse_args(argv)
  if args.threads:
    torch.set_num_threads(args.threads)
  device = resolve_device(args.device)
  out_dir = pathlib.Path(args.out_dir)
  for seed in args.seeds:
    name = curve_name('torch', 'cuda' if device.type == 'cuda' else 'cpu',
                      seed, args.tag)
    run(seed, device, args.scene_dir, out_dir / name, init_npz=args.init_npz,
        numpy_draws=args.numpy_draws, stop_at=args.stop_at,
        eval_every=args.eval_every)
    print(f'wrote {out_dir / name}', flush=True)


if __name__ == '__main__':
  main()
