"""Continuous evaluation CLI of the port, on one card.

The counterpart of eval.py (the JAX package's CLI) for one CUDA device: a
daemon that polls for checkpoints of the port's trainer, renders
validation, train and novel-view (test) cameras with the rays made on the
device (`evaluation.render_camera`), computes PSNR, MS-SSIM and LPIPS,
writes colorized depth, accumulation and error maps to TensorBoard and
PNGs, and keeps the renders of the newest `max_render_checkpoints`:

  python -m nerfies_tpu_torch.eval --base_folder EXP --data_dir SCENE \\
      --gin_configs configs/tpu_vrig_paper.gin \\
      --gin_bindings 'EvalConfig.eval_once = True'

`--fast_preview` renders 32 + 64 samples a ray culled to 16 + 32 through
an occupancy grid that is baked anew from every checkpoint. `--device
cpu` runs the plain PyTorch path; without it the CLI needs a card. A
model that `fast_render.supported` does not cover renders through
NerfModel.forward, as the JAX eval renders it through `model.apply`, and
unculled, with a warning, if culling was asked for. TensorBoard is
optional.

Under `torchrun` every rank takes part in every render, each rendering
its slice of every chunk (`evaluation.render_camera`), and rank 0 alone
computes the metrics on the gathered image and writes summaries, PNGs
and the render rotation (eval.py:348-395 on a mesh). Each rank bakes the
same occupancy grid: the bake is deterministic.

`main` returns what the run measured (`Result`).
"""

import argparse
import collections
import dataclasses
import functools
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerfies_tpu_torch import camera as camera_lib
from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import gpath
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import lpips
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import occupancy
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import training
from nerfies_tpu_torch import utils
from nerfies_tpu_torch import visualization as viz
from nerfies_tpu_torch.models import nerf as models
from nerfies_tpu_torch.ops import mathutils
from nerfies_tpu_torch.ops import ssim as ssim_lib
from nerfies_tpu_torch.parallel import mesh

log = logging.getLogger('nerfies_tpu_torch.eval')


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Evaluates the checkpoints of a Nerfies experiment with '
      'the PyTorch port.')
  parser.add_argument('--base_folder', required=True,
                      help='where to store ckpts and logs')
  parser.add_argument('--data_dir', default=None,
                      help='input data directory.')
  parser.add_argument('--gin_bindings', action='append', default=None,
                      help='Gin parameter bindings.')
  parser.add_argument('--gin_configs', action='append', default=[],
                      help='Gin config files.')
  parser.add_argument('--fast_preview', action='store_true',
                      help='One-flag fast serving preset: 32+64 samples/ray, '
                      'occupancy-culled to 16+32 (equivalent to '
                      'EvalConfig.fast_preview = True).')
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  return parser.parse_args(argv)


def apply_fast_preview(eval_config, fast_preview: bool = False) -> None:
  """The `fast_preview` preset of eval.py:281-300, in place.

  32 + 64 samples culled to 16 + 32 through the occupancy grid; explicit
  sample counts and keeps win over the preset. As in the JAX CLI, the
  preset turns `use_occupancy_culling` on even where a binding set it
  False.
  """
  if fast_preview:
    eval_config.fast_preview = True
  if not eval_config.fast_preview:
    return
  if eval_config.num_coarse_samples is None:
    eval_config.num_coarse_samples = 32
  if eval_config.num_fine_samples is None:
    eval_config.num_fine_samples = 64
  eval_config.use_occupancy_culling = True
  if eval_config.occupancy_keep_coarse is None:
    eval_config.occupancy_keep_coarse = 16
  if eval_config.occupancy_keep_fine is None:
    eval_config.occupancy_keep_fine = 32
  log.info('fast_preview: samples %d+%d, occupancy-culled to %d+%d.',
           eval_config.num_coarse_samples, eval_config.num_fine_samples,
           eval_config.occupancy_keep_coarse, eval_config.occupancy_keep_fine)


def parse_configs(gin_configs: Sequence[str],
                  gin_bindings: Optional[Sequence[str]] = None,
                  fast_preview: bool = False):
  """Parses the gin files and bindings into the four configs.

  Clears earlier bindings first; applies the fast_preview preset.

  Returns:
    (ExperimentConfig, ModelConfig, TrainConfig, EvalConfig).
  """
  gin.clear_config()
  gin.add_search_path('configs')
  gin.parse_config_files_and_bindings(config_files=gin_configs,
                                      bindings=gin_bindings)
  exp_config = configs.ExperimentConfig()
  model_config = configs.ModelConfig(use_stratified_sampling=False)
  train_config = configs.TrainConfig()
  eval_config = configs.EvalConfig()
  apply_fast_preview(eval_config, fast_preview)
  return exp_config, model_config, train_config, eval_config


def _make_summary_writer(summary_dir):
  try:
    from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter(str(summary_dir))
  except ImportError:
    log.warning('No TensorBoard writer available; logging to console.')
    return None


def compute_multiscale_ssim(image1: np.ndarray, image2: np.ndarray,
                            device='cpu') -> float:
  """MS-SSIM between two float images, on `device` (eval.py:58-81).

  Images too small for the 5 dyadic scales of the 11-pixel window use
  the feasible number of scales with renormalised power weights; below
  one scale the metric is NaN.
  """
  num_scales = ssim_lib.max_feasible_scales(image1.shape[0], image1.shape[1])
  weights = ssim_lib.MSSSIM_WEIGHTS
  if num_scales == 0:
    log.warning('Image %dx%d smaller than the SSIM window; skipping '
                'MS-SSIM.', image1.shape[0], image1.shape[1])
    return float('nan')
  if num_scales < len(weights):
    log.warning(
        'Image %dx%d too small for %d-scale MS-SSIM; using %d scales '
        '(renormalized weights).', image1.shape[0], image1.shape[1],
        len(weights), num_scales)
    truncated = weights[:num_scales]
    weights = tuple(w / sum(truncated) for w in truncated)
  as_tensor = lambda im: torch.from_numpy(np.asarray(im)).to(device)
  return float(ssim_lib.multiscale_ssim(as_tensor(image1), as_tensor(image2),
                                        weights=weights))


def process_batch(*, batch, state, tag, item_id, step, render_fn,
                  summary_writer, save_dir, datasource, chunk=8192,
                  lpips_fn=None):
  """Renders one example and logs its metrics and images (eval.py:84-181).

  A batch with 'camera_params' (and scalar metadata ids) renders through
  `evaluation.render_camera`, the rays made on the device; one with
  'origins' and 'directions' arrays through `evaluation.render_image`.
  Under a process group every rank renders; only rank 0 goes on to the
  metrics and writes (the others return the render's timings).
  """
  if 'camera_params' in batch:
    camera = camera_lib.Camera(**batch['camera_params'])
    out = evaluation.render_camera(state, camera, batch['metadata'],
                                   render_fn, chunk=chunk)
  else:
    rays_dict = {
        'origins': batch['origins'],
        'directions': batch['directions'],
        'metadata': batch['metadata'],
    }
    out = evaluation.render_image(state, rays_dict, render_fn, chunk=chunk)
  rgb = out['rgb']
  acc = out['acc']
  depth_exp = out['depth']
  depth_med = out['med_depth']
  stats = {'render_time': out['render_time'],
           'rays_per_sec': out['rays_per_sec']}
  if not mesh.is_main():
    return stats

  depth_norm = functools.partial(
      viz.colorize, cmin=datasource.near, cmax=datasource.far, cmap='turbo',
      invert=True)
  images = {
      'rgb': rgb,
      'acc': viz.colorize(acc, cmin=0.0, cmax=1.0),
      'depth_expected': depth_norm(depth_exp),
      'depth_median': depth_norm(depth_med),
  }

  if 'rgb' in batch:
    target = np.asarray(batch['rgb'][..., :3])
    mse = float(((rgb - target) ** 2).mean())
    stats['mse'] = mse
    stats['psnr'] = float(mathutils.compute_psnr(
        torch.tensor(mse, dtype=torch.float32)))
    ms_ssim = compute_multiscale_ssim(target, rgb, render_fn.device)
    if not np.isnan(ms_ssim):
      stats['ms_ssim'] = ms_ssim
    if lpips_fn is not None:
      key = 'lpips' if lpips_fn.calibrated else 'lpips_uncal'
      stats[key] = lpips_fn(target, rgb)
    abs_error = np.abs(target - rgb).mean(axis=-1)
    images['rgb_target'] = target
    images['error_abs'] = viz.colorize(abs_error, cmin=0.0, cmax=1.0)
    images['error_sq'] = viz.colorize(abs_error ** 2, cmin=0.0, cmax=1.0)

  if 'depth' in batch:
    # Depth MAE against the ground-truth depth where it is defined.
    gt_depth = np.asarray(batch['depth'])[..., 0]
    valid = gt_depth > 0
    if valid.any():
      stats['depth_mae'] = float(np.abs(depth_med - gt_depth)[valid].mean())
      images['depth_gt'] = depth_norm(gt_depth)

  if summary_writer is not None:
    for name, image in images.items():
      summary_writer.add_image(f'{tag}/{item_id}/{name}', image, step,
                               dataformats='HWC')
    for name in ('psnr', 'ms_ssim', 'lpips', 'lpips_uncal'):
      if name in stats:
        summary_writer.add_scalar(f'metrics/{tag}/{item_id}/{name}',
                                  stats[name], step)

  if save_dir is not None:
    item_dir = save_dir / tag / item_id
    item_dir.mkdir(parents=True, exist_ok=True)
    image_utils.save_image(item_dir / 'rgb.png',
                           image_utils.image_to_uint8(rgb))
    image_utils.save_image(item_dir / 'depth_median.png',
                           image_utils.image_to_uint8(images['depth_median']))
    image_utils.save_depth(item_dir / 'depth_median_raw.png', depth_med)
    image_utils.save_image(item_dir / 'acc.png',
                           image_utils.image_to_uint8(images['acc']))

  log.info('[%s/%s] %s', tag, item_id,
           ', '.join(f'{k}={v:.4f}' for k, v in stats.items()))
  return stats


def process_iterator(*, tag, item_ids, iterator, state, step, render_fn,
                     summary_writer, save_dir, datasource, chunk=8192,
                     lpips_fn=None):
  """Renders a set of examples (eval.py:184-205).

  Returns:
    (metric means, [(item_id, stats)] of each example).
  """
  meters = collections.defaultdict(utils.ValueMeter)
  items = []
  for item_id, batch in zip(item_ids, iterator):
    stats = process_batch(
        batch=batch, state=state, tag=tag, item_id=item_id, step=step,
        render_fn=render_fn, summary_writer=summary_writer,
        save_dir=save_dir, datasource=datasource, chunk=chunk,
        lpips_fn=lpips_fn)
    items.append((item_id, stats))
    for k, v in stats.items():
      meters[k].update(v)
  if summary_writer is not None:
    for k, meter in meters.items():
      summary_writer.add_scalar(f'metrics/{tag}/mean_{k}',
                                meter.reduce('mean'), step)
  return {k: float(meter.reduce('mean')) for k, meter in meters.items()}, items


def delete_old_renders(render_dir, max_renders: int):
  """Keeps only the newest `max_renders` render checkpoints."""
  render_dir = gpath.GPath(render_dir)
  if not render_dir.exists():
    return
  paths = sorted((p for p in render_dir.iterdir() if p.is_dir()),
                 key=lambda p: int(p.name))
  for path in paths[:-max_renders] if max_renders else paths:
    log.info('Removing old renders: %s', str(path))
    path.rmtree()


def _draw_test_metadata(datasource, model_config, rng):
  """Random metadata ids for a novel-view camera (eval.py:225-243).

  Draws from the numpy generator in the JAX CLI's order: warp,
  appearance, camera, time (float32).
  """
  metadata_ids = {}
  if model_config.use_warp:
    metadata_ids['warp'] = int(rng.choice(datasource.warp_ids))
  if model_config.use_appearance_metadata:
    metadata_ids['appearance'] = int(rng.choice(datasource.appearance_ids))
  if model_config.use_camera_metadata:
    metadata_ids['camera'] = int(rng.choice(datasource.camera_ids))
  if model_config.warp_metadata_encoder_type == 'time':
    metadata_ids['time'] = float(rng.uniform(0.0, 1.0))
  return metadata_ids


def _test_cameras_iterator(datasource, cameras, model_config, seed=20200823):
  """Camera batches for novel-view renders with random metadata ids."""
  rng = np.random.default_rng(seed)
  for camera in cameras:
    metadata_ids = _draw_test_metadata(datasource, model_config, rng)
    log.info('Test camera metadata: %s', metadata_ids)
    yield {
        'camera_params': camera.get_parameters(),
        'metadata': metadata_ids,
    }


def _camera_items_iterator(datasource, item_ids):
  """Eval batches as camera params + ground-truth images (no host rays)."""
  for item_id in item_ids:
    item = datasource.get_item(item_id)
    batch = {
        'camera_params': item['camera_params'],
        'metadata': item['metadata'],
        'rgb': image_utils.image_to_float32(item['rgb'][..., :3]),
    }
    if 'depth' in item:
      batch['depth'] = item['depth']
    yield batch


def bake_occupancy(params, model, datasource, eval_config, device):
  """Bakes an occupancy grid from a checkpoint's density (eval.py:362-384).

  Returns:
    (the grid, {'seconds', 'occupied', 'resolution'}): seconds of the bake
    to the occupied share read back, host clock.
  """
  start = time.perf_counter()
  points = datasource.load_points()
  lo, hi = points.min(axis=0), points.max(axis=0)
  margin = (eval_config.occupancy_bbox_margin * float((hi - lo).max())
            + eval_config.occupancy_bbox_margin)
  level = 'fine' if model.num_fine_samples > 0 else 'coarse'
  sigma_fn = occupancy.sigma_fn_from_params(params, model, level=level)
  grid = occupancy.build_grid(
      sigma_fn, bbox_min=lo - margin, bbox_max=hi + margin,
      resolution=eval_config.occupancy_resolution,
      sigma_threshold=eval_config.occupancy_sigma_threshold, device=device)
  occupied = float(grid.occupied.float().mean())
  bake = {'seconds': time.perf_counter() - start, 'occupied': occupied,
          'resolution': eval_config.occupancy_resolution}
  log.info('Occupancy grid baked: %.1f%% occupied at %d^3 in %.2f s.',
           100.0 * occupied, eval_config.occupancy_resolution,
           bake['seconds'])
  return grid, bake


@dataclasses.dataclass
class Result:
  """What a run evaluated: per step, the metric means of each tag; every
  example's stats as (step, tag, item_id, stats); and each bake's
  `bake_occupancy` numbers with its step."""
  exp_dir: Any
  metrics: Dict[int, Dict[str, Dict[str, float]]]
  frames: List[Any]
  bakes: List[Dict[str, Any]]


def evaluate(args: argparse.Namespace) -> Result:
  """eval.py's main: set-up, then the checkpoint loop, on this process's
  device (joining the torchrun group, if any)."""
  device = mesh.init(args.device)
  if not mesh.is_main():
    log.setLevel(logging.WARNING)
  exp_config, model_config, train_config, eval_config = parse_configs(
      args.gin_configs, args.gin_bindings, args.fast_preview)

  exp_dir = gpath.GPath(args.base_folder)
  if exp_config.subname:
    exp_dir = exp_dir / exp_config.subname
  summary_dir = exp_dir / 'summaries' / 'eval'
  checkpoint_dir = exp_dir / 'checkpoints'
  render_root = exp_dir / 'renders'

  datasource_spec = exp_config.datasource_spec
  if datasource_spec is None:
    datasource_spec = {
        'type': exp_config.datasource_type,
        'data_dir': args.data_dir,
    }
  datasource = datasets.from_config(
      datasource_spec,
      image_scale=exp_config.image_scale,
      use_appearance_id=model_config.use_appearance_metadata,
      use_camera_id=model_config.use_camera_metadata,
      use_warp_id=model_config.use_warp,
      use_time=model_config.warp_metadata_encoder_type == 'time',
      # Frames with a depth map feed the depth-MAE metric; the others skip.
      use_depth=True,
      random_seed=exp_config.random_seed,
      **dict(exp_config.datasource_kwargs))

  if eval_config.num_coarse_samples is not None:
    model_config.num_coarse_samples = eval_config.num_coarse_samples
  if eval_config.num_fine_samples is not None:
    model_config.num_fine_samples = eval_config.num_fine_samples
  model, params = models.construct_nerf(
      model_config,
      appearance_ids=datasource.appearance_ids,
      camera_ids=datasource.camera_ids,
      warp_ids=datasource.warp_ids,
      near=datasource.near,
      far=datasource.far,
      generator=torch.Generator().manual_seed(exp_config.random_seed),
      device=device)
  warp_alpha_sched = schedules.from_config(train_config.warp_alpha_schedule)
  time_alpha_sched = schedules.from_config(train_config.time_alpha_schedule)
  state = training.create_train_state(params)
  render_fn = evaluation.make_render_fn(model, device=device)
  if eval_config.use_occupancy_culling and not render_fn.fast:
    log.warning('EvalConfig.use_occupancy_culling is set but the model is '
                'not covered by the fused serving path '
                '(fast_render.supported); rendering unculled.')
    eval_config.use_occupancy_culling = False

  lpips_fn = None
  if eval_config.compute_lpips and mesh.is_main():
    lpips_fn = lpips.LPIPS(weights_path=eval_config.lpips_weights,
                           device=device)
    if not lpips_fn.calibrated:
      log.warning(
          'No LPIPS weights file configured (EvalConfig.lpips_weights); '
          'reporting the seeded random-feature fallback as lpips_uncal.')

  summary_writer = (_make_summary_writer(summary_dir) if mesh.is_main()
                    else None)

  val_ids = utils.strided_subset(datasource.val_ids, eval_config.num_val_eval)
  train_ids = utils.strided_subset(datasource.train_ids,
                                   eval_config.num_train_eval)
  test_cameras = datasource.load_test_cameras(
      count=eval_config.num_test_eval)

  result = Result(exp_dir, {}, [], [])
  last_step = 0
  while True:
    # Rank 0's reading, so that every rank evaluates the same checkpoint.
    step = mesh.broadcast_object(
        checkpoints.latest_checkpoint_step(checkpoint_dir))
    if step is None or step <= last_step:
      if eval_config.eval_once:
        break
      log.info('No new checkpoint (last=%d); sleeping.', last_step)
      time.sleep(10)
      continue

    state = checkpoints.restore_checkpoint(checkpoint_dir, state)
    state = dataclasses.replace(state,
                                warp_alpha=float(warp_alpha_sched(step)),
                                time_alpha=float(time_alpha_sched(step)))
    log.info('Evaluating checkpoint at step %d', step)
    if eval_config.use_occupancy_culling:
      # The grid depends on the checkpoint's density field, so it (and the
      # render fn over it) is baked anew for every checkpoint.
      grid, bake = bake_occupancy(state.params, model, datasource,
                                  eval_config, device)
      result.bakes.append({'step': step, **bake})
      render_fn = evaluation.make_render_fn(
          model, device=device, occupancy=grid,
          keep_samples=(eval_config.occupancy_keep_coarse,
                        eval_config.occupancy_keep_fine))

    save_dir = (render_root / f'{step}'
                if eval_config.save_output and mesh.is_main() else None)
    run = functools.partial(
        process_iterator, state=state, step=step, render_fn=render_fn,
        summary_writer=summary_writer, save_dir=save_dir,
        datasource=datasource, chunk=eval_config.chunk, lpips_fn=lpips_fn)
    sets = []
    if val_ids:
      sets.append(('val', val_ids,
                   _camera_items_iterator(datasource, val_ids)))
    if train_ids:
      sets.append(('train', train_ids,
                   _camera_items_iterator(datasource, train_ids)))
    if test_cameras:
      sets.append(('test', [f'{i:04d}' for i in range(len(test_cameras))],
                   _test_cameras_iterator(
                       datasource, test_cameras, model_config,
                       seed=exp_config.random_seed + step)))
    result.metrics[step] = {}
    for tag, ids, iterator in sets:
      means, items = run(tag=tag, item_ids=ids, iterator=iterator)
      result.metrics[step][tag] = means
      result.frames += [(step, tag, i, stats) for i, stats in items]

    if eval_config.save_output and mesh.is_main():
      delete_old_renders(render_root, eval_config.max_render_checkpoints)

    last_step = step
    if eval_config.eval_once:
      break
  if summary_writer is not None:
    summary_writer.close()
  return result


def main(argv: Optional[Sequence[str]] = None) -> Result:
  args = parse_args(argv)
  if not logging.getLogger().handlers:
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
  return evaluate(args)


if __name__ == '__main__':
  main()
  mesh.shutdown()
