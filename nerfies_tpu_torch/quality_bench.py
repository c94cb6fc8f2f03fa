"""Converged-quality benchmark: train N steps on the textured synthetic
scene and record the PSNR / MS-SSIM curve.

The port's counterpart of scripts/quality_bench.py, on one card or, under
`torchrun`, data-parallel over the cards of a machine:

  python -m nerfies_tpu_torch.quality_bench --steps 20000 \\
      --eval_every 2000 --out quality_curve.json \\
      --save_params quality_params.npz
  torchrun --standalone --nproc_per_node=4 -m \\
      nerfies_tpu_torch.quality_bench ...

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

`--stop_at` ends a run early on the schedules of --steps (the learning
rate decays and the warp window opens over --steps), as
docs/quality_curve.json holds the first 6,000 steps of a 20,000-step run;
such a curve is marked partial. On a card the curve also names the card
and its power limit, as nvidia-smi reads them.

`--init_npz` starts from a param tree of '/'-joined names instead of the
port's own init: JAX's PRNGKey(0) tree of scripts/quality_bench.py, as
scripts/quality_init_jax.py writes it into
nerfies_tpu_torch/curves/init/. The steps' draws still come from --seed.
The curve then records `"init": "jax"` and the file's sha256.

Two behaviours of the JAX script are not copied: `--resume` is off by
default (a run starts fresh unless asked), and a resumed run advances the
ray and background-point iterators past the steps already taken, so it
trains on the batches an unbroken run would (the step's random stream is
a function of the step, `training.step_generator`), and renders the
restored state once so that its next render_delta is the unbroken run's. The defaults of
--scene_dir, --work_dir and --out lie under the temporary directory, in
a folder of the port's own.

Under `torchrun` (parallel/mesh.py, as JAX's script runs on the mesh)
each rank trains its contiguous rows of every global batch and of the
background points, the step's draws are made at the global rows
(`mesh.RankRows`) and its one all-reduce averages the gradients, so N
ranks compute what one process computes; the evals render through
`render_image`'s rank split. Rank 0 writes the scene (the others wait
for it), the curve, the npz and the checkpoints; --batch_size must
divide by the world size.

Without a card pass --device cpu (the kernels' plain versions; gloo
ranks under `torchrun`).
"""

import argparse
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import core as datasets_core
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import ssim as metrics_ops
from nerfies_tpu_torch.parallel import mesh

# The folder of the port's bench files under the temporary directory.
DEFAULT_DIR = os.path.join(tempfile.gettempdir(),
                           'nerfies_tpu_torch_quality')
EVAL_CHUNK = 8192
# --seed s draws the params from seed 2s and the steps from 2s + 1, and
# shuffles the rays and background points with s.
PARAMS_SEED = 0
STEP_SEED = 1


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Trains the textured synthetic scene and records its '
      'quality curve.')
  parser.add_argument('--steps', type=int, default=20000,
                      help='the schedules\' length (learning rate, warp '
                      'alpha)')
  parser.add_argument('--stop_at', type=int, default=0,
                      help='end the run after this step of the --steps '
                      'schedules (0: run all --steps); the curve is then '
                      'marked partial')
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
  parser.add_argument('--seed', type=int, default=0,
                      help='a replicate of the run: the params, the '
                      'steps\' draws and the data order from other seeds')
  parser.add_argument('--init_npz', default='',
                      help="start from this npz's params ('/'-joined "
                      "names; scripts/quality_init_jax.py writes JAX's) "
                      "instead of the port's init of --seed")
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  return parser.parse_args(argv)


def model_config(fused: bool = True) -> configs.ModelConfig:
  """The bench model (bench.py's model_config) with rgb padding 0.001."""
  model, _ = configs.bench_train_config()
  return dataclasses.replace(model, use_fused_mlp=fused,
                             use_fused_warp=fused, rgb_padding=0.001)


def card_label() -> Optional[Tuple[str, str]]:
  """The card's name and power limit as nvidia-smi prints them, or None
  where nvidia-smi does not run."""
  try:
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
  except (OSError, subprocess.SubprocessError):
    return None
  name, _, limit = smi.stdout.strip().splitlines()[0].rpartition(', ')
  return name, limit


def log(message: str) -> None:
  """Prints on rank 0 only."""
  if mesh.is_main():
    print(message, flush=True)


def write_scene(args: argparse.Namespace) -> pathlib.Path:
  """The textured, moving synthetic capture, written once (by rank 0;
  every rank waits for it)."""
  scene = pathlib.Path(args.scene_dir)
  if mesh.is_main() and not (scene / 'dataset.json').exists():
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
  mesh.barrier()
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


def load_init(path, like, device) -> dict:
  """The npz's param tree on `device`, its names and shapes those of the
  param tree `like`.

  Raises:
    ValueError: a name or a shape that differs from `like`'s.
  """
  params = interop.params_from_jax(interop.load_npz_tree(path), device)
  want = {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(like)}
  got = {p: tuple(t.shape) for p, t in fused_mlp.flatten_tree(params)}
  if got != want:
    names = sorted('/'.join(p) for p in set(got) ^ set(want)) or sorted(
        '/'.join(p) for p in got if got[p] != want[p])
    raise ValueError(f'{path} does not hold the model\'s params: {names}')
  return params


def file_sha256(path) -> str:
  return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


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
  scripts/quality_bench.py, on args.device (this rank's card under
  `torchrun`).

  Raises:
    ValueError: a batch size that the world size does not divide, or a
      --stop_at past --steps.
  """
  device = mesh.init(args.device)
  if args.batch_size % mesh.world_size() != 0:
    raise ValueError('Batch size must be divisible by the number of devices.')
  if not 0 <= args.stop_at <= args.steps:
    raise ValueError(f'--stop_at {args.stop_at} lies outside [0, --steps '
                     f'{args.steps}].')
  scene = write_scene(args)
  datasource = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True, random_seed=args.seed)
  _, bench_train = configs.bench_train_config()
  train_config = dataclasses.replace(bench_train, batch_size=args.batch_size)
  ids = dict(appearance_ids=datasource.appearance_ids,
             camera_ids=datasource.camera_ids,
             warp_ids=datasource.warp_ids,
             near=datasource.near, far=datasource.far)
  params_seed = PARAMS_SEED + 2 * args.seed
  step_seed = STEP_SEED + 2 * args.seed
  model, params = nerf.construct_nerf(
      config, generator=torch.Generator().manual_seed(params_seed),
      device=device, use_warp_jacobian=True, use_weights=True, **ids)
  if args.init_npz:
    params = load_init(args.init_npz, params, device)
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
  points_batch_size = min(len(points),
                          train_config.background_points_batch_size)
  points_batch_size -= points_batch_size % mesh.world_size()
  # Every rank draws the global points batch and keeps its rows (the ray
  # iterator slices its batches by rank itself).
  rows = mesh.local_batch_slice(points_batch_size)
  points_iter = (batch[rows] for batch in datasets_core.iterator_from_arrays(
      points, batch_size=points_batch_size, shuffle=True, seed=args.seed,
      prefetch_size=3))

  # The serving model: deterministic samples, the serving kernels.
  eval_config = dataclasses.replace(config, use_stratified_sampling=False,
                                    use_fused_mlp=False, use_fused_warp=True)
  eval_model, _ = nerf.construct_nerf(
      eval_config, generator=torch.Generator().manual_seed(params_seed),
      device=device, **ids)
  render_fn = evaluation.make_render_fn(eval_model, device=device)
  # The val frames reuse train metadata ids and show that frame's state,
  # so val PSNR is the novel-view signal and the train view the fit's.
  val_rays, val_rgb = load_view(datasource, datasource.val_ids[0])
  train_rays, train_rgb = load_view(datasource, datasource.train_ids[0])

  out_path = pathlib.Path(args.out)
  if mesh.is_main():
    out_path.parent.mkdir(parents=True, exist_ok=True)
  device_name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
                 else 'cpu')
  card = card_label() if device.type == 'cuda' else None
  last_step = args.stop_at or args.steps
  init_sha256 = file_sha256(args.init_npz) if args.init_npz else None

  def write_result(curve, partial=False):
    result = {
        'workload': 'quarter-HD-class synthetic (textured, moving sphere)',
        'image_size': list(args.image_size),
        'batch_size': args.batch_size,
        'steps': args.steps,
        'device': device_name,
        'curve': curve,
    }
    if card is not None:
      result['card'], result['power_limit'] = card
    if args.init_npz:
      result['init'] = 'jax'
      result['init_sha256'] = init_sha256
    if partial:
      result['partial'] = True
    # allow_nan=False: a non-finite value fails here, not in a reader.
    text = json.dumps(result, indent=2, allow_nan=False)
    if mesh.is_main():
      out_path.write_text(text)
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
      log(f'resumed from step {start_step} ({len(curve)} prior evals)')

  step_seconds = []
  t_start = time.time()
  for step in range(start_step + 1, last_step + 1):
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
        training.step_generator(step_seed, step, device), state, batch,
        scalar_params)
    loss = float(stats['fine']['loss/rgb'])  # waits for the step
    step_seconds.append(time.perf_counter() - tick)
    if step % args.eval_every == 0 or step == last_step:
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
      log(json.dumps(curve[-1]))
      write_result(curve, partial=True)
      checkpoints.save_checkpoint(args.work_dir, state, step=step, keep=2)
      if args.save_params and mesh.is_main():
        save_params(args.save_params, state)

  result = write_result(curve, partial=last_step < args.steps)
  if step_seconds:
    log(f'step median {1e3 * float(np.median(step_seconds)):.2f} ms over '
        f'{len(step_seconds)} steps')
  log(f'wrote {args.out}')
  if args.save_params and mesh.is_main():
    save_params(args.save_params, state)
    log(f'saved params to {args.save_params}')
  mesh.barrier()  # every rank returns with rank 0's files in place
  return Result(result, state, step_seconds)


def main(argv: Optional[Sequence[str]] = None) -> Result:
  args = parse_args(argv)
  return run(args, model_config(args.fused))


if __name__ == '__main__':
  main()
  mesh.shutdown()
