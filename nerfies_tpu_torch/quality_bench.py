"""Converged-quality benchmark: train N steps on the textured synthetic
scene and record the PSNR / MS-SSIM curve.

The port's counterpart of scripts/quality_bench.py, on one card:

  python -m nerfies_tpu_torch.quality_bench --steps 20000 \\
      --eval_every 2000 --out quality_curve.json \\
      --save_params quality_params.npz

The workload is the bench training workload (`configs.bench_train_config`:
SE(3) warp, elastic 'weight' over dense coarse Jacobians, background
loss, bf16, batch 6144, 128 + 128 samples) with rgb padding 0.001 as in
configs/tpu_*.gin, through `training.make_train_step` (the fused kernels;
--no-fused trains through the plain forward), on a 384x288
high-frequency-textured, moving synthetic capture. Every --eval_every
steps it renders the first val view and the first train view through
the serving path (`evaluation.make_render_fn`), writes the curve (the JAX
script's keys) and a checkpoint of the full state into --work_dir.

`--save_params` writes the JAX script's `.npz` layout: the param names
flattened with '/', plus `__warp_alpha__` and `__time_alpha__`; an npz of
either package loads in either's serve bench.

Two behaviours of the JAX script are not copied: `--resume` is off by
default (a run starts fresh unless asked), and a resumed run advances the
ray and background-point iterators past the steps already taken, so it
trains on the batches an unbroken run would (the step's random stream is
a function of the step, `training.step_generator`), and renders the
restored state once so that its next render_delta is the unbroken run's. The defaults of
--scene_dir, --work_dir and --out lie under the temporary directory, in
a folder of the port's own.

Without a card pass --device cpu (the kernels' plain versions).
"""

import argparse
import dataclasses
import json
import os
import pathlib
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import core as datasets_core
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import ssim as metrics_ops

# The folder of the port's bench files under the temporary directory.
DEFAULT_DIR = os.path.join(tempfile.gettempdir(),
                           'nerfies_tpu_torch_quality')
EVAL_CHUNK = 8192
PARAMS_SEED = 0
STEP_SEED = 1


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Trains the textured synthetic scene and records its '
      'quality curve.')
  parser.add_argument('--steps', type=int, default=20000)
  parser.add_argument('--eval_every', type=int, default=2000)
  parser.add_argument('--batch_size', type=int, default=6144)
  parser.add_argument('--scene_dir',
                      default=os.path.join(DEFAULT_DIR, 'scene'))
  parser.add_argument('--image_size', type=int, nargs=2, default=(384, 288))
  parser.add_argument('--out',
                      default=os.path.join(DEFAULT_DIR, 'quality_curve.json'))
  parser.add_argument('--num_train', type=int, default=24)
  parser.add_argument('--texture_frequency', type=float, default=20.0,
                      help='procedural texture frequency; high enough that '
                      'the fit does not saturate within --steps')
  parser.add_argument('--motion_amplitude', type=float, default=0.15)
  parser.add_argument('--cameras_per_state', type=int, default=2,
                      help='training cameras per deformation state (2: the '
                      'validation-rig regime; 1: monocular video)')
  parser.add_argument('--save_params', default='',
                      help='optional .npz path for the final params '
                      '(flattened tree and the warp alphas), for '
                      'nerfies_tpu_torch.serve_bench')
  parser.add_argument('--fused', action=argparse.BooleanOptionalAction,
                      default=True,
                      help='train through the fused kernels (the tpu_*.gin '
                      'route); --no-fused through the plain forward')
  parser.add_argument('--work_dir',
                      default=os.path.join(DEFAULT_DIR, 'work'),
                      help='checkpoint directory: the full TrainState is '
                      'saved at every eval')
  parser.add_argument('--resume', action=argparse.BooleanOptionalAction,
                      default=False,
                      help='restore the latest --work_dir checkpoint and '
                      'the matching prefix of the existing --out curve, '
                      'then continue; off by default')
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  return parser.parse_args(argv)


def model_config(fused: bool = True) -> configs.ModelConfig:
  """The bench model (bench.py's model_config) with rgb padding 0.001."""
  model, _ = configs.bench_train_config()
  return dataclasses.replace(model, use_fused_mlp=fused,
                             use_fused_warp=fused, rgb_padding=0.001)


def write_scene(args: argparse.Namespace) -> pathlib.Path:
  """The textured, moving synthetic capture, written once."""
  scene = pathlib.Path(args.scene_dir)
  if not (scene / 'dataset.json').exists():
    # A textured environment sphere as background: a constant-white one
    # collapses training into rgb-sigmoid saturation.
    synthetic.write_synthetic_dataset(
        scene, num_train=args.num_train, num_val=2,
        image_size=tuple(args.image_size),
        motion_amplitude=args.motion_amplitude,
        texture_frequency=args.texture_frequency,
        cameras_per_state=args.cameras_per_state,
        env_background=True, num_points=16384)
    print('scene written', flush=True)
  return scene


def load_view(datasource, item_id):
  """An item's rays (render_image's input) and its ground-truth rgb."""
  item = next(iter(datasource.create_iterator([item_id], batch_size=0,
                                              repeat=False)))
  rays = {k: item[k] for k in ('origins', 'directions', 'metadata')}
  return rays, item['rgb']


def psnr(pred, target) -> float:
  return float(-10.0 * np.log10(np.mean((pred - target) ** 2)))


def ms_ssim(pred, target) -> Optional[float]:
  """MS-SSIM over the scales the image supports, the power weights
  renormalised; None where none fits."""
  num_scales = metrics_ops.max_feasible_scales(*pred.shape[:2])
  if not num_scales:
    return None
  weights = metrics_ops.MSSSIM_WEIGHTS[:num_scales]
  weights = tuple(w / sum(weights) for w in weights)
  return float(metrics_ops.multiscale_ssim(pred, target, weights=weights))


def save_params(path, state) -> None:
  """The npz layout: '/'-joined param names, plus the warp alphas."""
  flat = {'/'.join(p): t.detach().cpu().numpy()
          for p, t in fused_mlp.flatten_tree(state.params)}
  flat['__warp_alpha__'] = np.asarray(state.warp_alpha, np.float32)
  flat['__time_alpha__'] = np.asarray(state.time_alpha, np.float32)
  np.savez(path, **flat)


@dataclasses.dataclass
class Result:
  """What a run wrote (the curve file's dict), its final state and the
  seconds of each timed step."""
  result: Dict[str, Any]
  state: training.TrainState
  step_seconds: List[float]


def run(args: argparse.Namespace, config: configs.ModelConfig) -> Result:
  """Trains `config` on the bench scene: the loop of
  scripts/quality_bench.py, on args.device."""
  device = resolve_device(args.device)
  scene = write_scene(args)
  datasource = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True, random_seed=0)
  _, bench_train = configs.bench_train_config()
  train_config = dataclasses.replace(bench_train, batch_size=args.batch_size)
  ids = dict(appearance_ids=datasource.appearance_ids,
             camera_ids=datasource.camera_ids,
             warp_ids=datasource.warp_ids,
             near=datasource.near, far=datasource.far)
  model, params = nerf.construct_nerf(
      config, generator=torch.Generator().manual_seed(PARAMS_SEED),
      device=device, use_warp_jacobian=True, use_weights=True, **ids)
  step_fn = training.make_train_step(model, train_config, device)
  state = training.create_train_state(params)

  lr_sched = schedules.from_config(('exponential', 1e-3, 1e-4, args.steps))
  warp_alpha_sched = schedules.from_config(
      ('linear', 0.0, config.num_warp_freqs, min(args.steps, 80000)))
  elastic_sched = schedules.from_config(('constant', 1e-3))

  train_iter = datasource.create_iterator(
      datasource.train_ids, flatten=True, shuffle=True,
      batch_size=args.batch_size, prefetch_size=3)
  points = datasource.load_points(shuffle=True)
  points_iter = datasets_core.iterator_from_arrays(
      points, batch_size=min(len(points),
                             train_config.background_points_batch_size),
      shuffle=True, seed=0, prefetch_size=3)

  # The serving model: deterministic samples, the serving kernels.
  eval_config = dataclasses.replace(config, use_stratified_sampling=False,
                                    use_fused_mlp=False, use_fused_warp=True)
  eval_model, _ = nerf.construct_nerf(
      eval_config, generator=torch.Generator().manual_seed(PARAMS_SEED),
      device=device, **ids)
  render_fn = evaluation.make_render_fn(eval_model, device=device)
  # The val frames reuse train metadata ids and show that frame's state,
  # so val PSNR is the novel-view signal and the train view the fit's.
  val_rays, val_rgb = load_view(datasource, datasource.val_ids[0])
  train_rays, train_rgb = load_view(datasource, datasource.train_ids[0])

  out_path = pathlib.Path(args.out)
  out_path.parent.mkdir(parents=True, exist_ok=True)
  device_name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
                 else 'cpu')

  def write_result(curve, partial=False):
    result = {
        'workload': 'quarter-HD-class synthetic (textured, moving sphere)',
        'image_size': list(args.image_size),
        'batch_size': args.batch_size,
        'steps': args.steps,
        'device': device_name,
        'curve': curve,
    }
    if partial:
      result['partial'] = True
    # allow_nan=False: a non-finite value fails here, not in a reader.
    out_path.write_text(json.dumps(result, indent=2, allow_nan=False))
    return result

  curve = []
  start_step = 0
  wall_offset = 0.0
  prev_pred = None
  if args.resume:
    state = checkpoints.restore_checkpoint(args.work_dir, state)
    start_step = state.step
    if start_step:
      if out_path.exists():
        prior = json.loads(out_path.read_text())
        curve = [row for row in prior.get('curve', [])
                 if row['step'] <= start_step]
      if curve:
        wall_offset = curve[-1].get('wall_s', 0.0)
      # The batches of the steps already taken.
      for _ in range(start_step):
        next(train_iter)
        next(points_iter)
      # Checkpoints are written at evals: the unbroken run rendered this
      # state, and diffs its next eval against that render.
      with torch.no_grad():
        prev_pred = np.clip(evaluation.render_image(
            state, val_rays, render_fn, chunk=EVAL_CHUNK)['rgb'], 0, 1)
      print(f'resumed from step {start_step} ({len(curve)} prior evals)',
            flush=True)

  step_seconds = []
  t_start = time.time()
  for step in range(start_step + 1, args.steps + 1):
    batch = next(train_iter)
    batch['background_points'] = next(points_iter)
    scalar_params = training.ScalarParams(
        learning_rate=lr_sched(step),
        elastic_loss_weight=elastic_sched(step),
        background_loss_weight=1.0)
    state = dataclasses.replace(state, warp_alpha=float(
        warp_alpha_sched(step)))
    tick = time.perf_counter()
    state, stats = step_fn(
        training.step_generator(STEP_SEED, step, device), state, batch,
        scalar_params)
    loss = float(stats['fine']['loss/rgb'])  # waits for the step
    step_seconds.append(time.perf_counter() - tick)
    if step % args.eval_every == 0 or step == args.steps:
      if not np.isfinite(loss):
        raise FloatingPointError(f'step {step}: non-finite loss {loss}')
      with torch.no_grad():
        out = evaluation.render_image(state, val_rays, render_fn,
                                      chunk=EVAL_CHUNK)
        tout = evaluation.render_image(state, train_rays, render_fn,
                                       chunk=EVAL_CHUNK)
      pred = np.clip(out['rgb'], 0, 1)
      ssim_value = ms_ssim(pred, val_rgb)
      tv_psnr = psnr(np.clip(tout['rgb'], 0, 1), train_rgb)
      wall = wall_offset + (time.time() - t_start)
      # A converging fit changes the rendered view between evals; a zero
      # delta means the eval read a stale state. None with no previous
      # render to diff against.
      delta = (round(float(np.abs(pred - prev_pred).mean()), 8)
               if prev_pred is not None else None)
      prev_pred = pred
      curve.append({'step': step, 'val_psnr': round(psnr(pred, val_rgb), 5),
                    'train_view_psnr': round(tv_psnr, 5),
                    'val_ms_ssim': (round(ssim_value, 6)
                                    if ssim_value is not None else None),
                    'train_loss': round(loss, 6),
                    'render_delta': delta,
                    'warp_alpha': round(float(warp_alpha_sched(step)), 3),
                    'wall_s': round(wall, 1)})
      print(json.dumps(curve[-1]), flush=True)
      write_result(curve, partial=True)
      checkpoints.save_checkpoint(args.work_dir, state, step=step, keep=2)
      if args.save_params:
        save_params(args.save_params, state)

  result = write_result(curve)
  print(f'wrote {args.out}', flush=True)
  if args.save_params:
    save_params(args.save_params, state)
    print(f'saved params to {args.save_params}', flush=True)
  return Result(result, state, step_seconds)


def main(argv: Optional[Sequence[str]] = None) -> Result:
  args = parse_args(argv)
  return run(args, model_config(args.fused))


if __name__ == '__main__':
  main()
