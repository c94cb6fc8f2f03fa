"""Serving benchmark of a trained model: full render, reduced-sample
preset and occupancy-culled, with their quality against ground truth.

The port's counterpart of scripts/serve_bench.py, on one card. It loads
the params that `python -m nerfies_tpu_torch.quality_bench --save_params`
writes (or the JAX script's npz: the same layout), renders the scene's
first val view through four serving modes and records rays/s, PSNR and
MS-SSIM of each, and with --measure_1080p a 1920x1080 orbit frame's
seconds (rays made on the card, `evaluation.render_camera`):

  python -m nerfies_tpu_torch.quality_bench --steps 20000 \\
      --save_params quality_params.npz
  python -m nerfies_tpu_torch.serve_bench --params quality_params.npz \\
      --out serve_quality.json

Every mode renders through `evaluation.make_render_fn`, so through the
serving kernels (`fast_render.render_rays`). Without a card pass
--device cpu (their plain versions).
"""

import argparse
import dataclasses
import json
import os
import pathlib
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import occupancy
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp

HD_SIZE = (1920, 1080)
HD_THETA = 0.3
# The four modes: (name, coarse and fine samples, samples kept a ray after
# culling or None for no culling).
MODES = (
    ('full_256samples', (128, 128), None),
    ('preset_32+64', (32, 64), None),
    ('occupancy_128->32_+64->48', (128, 128), (32, 48)),
    ('occupancy_preset_32->16_+64->32', (32, 64), (16, 32)),
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Serving modes of a trained model: rays/s and quality.')
  parser.add_argument('--params', default=os.path.join(
      quality_bench.DEFAULT_DIR, 'quality_params.npz'))
  parser.add_argument('--scene_dir', default=os.path.join(
      quality_bench.DEFAULT_DIR, 'scene'))
  parser.add_argument('--chunk', type=int, default=8192)
  parser.add_argument('--hd_chunk', type=int, default=32768,
                      help='ray chunk for the measured 1080p frame')
  parser.add_argument('--measure_1080p',
                      action=argparse.BooleanOptionalAction, default=True,
                      help='render a real 1920x1080 frame per mode (rays '
                      'made on the card) and record its seconds')
  parser.add_argument('--grid_resolution', type=int, default=128)
  parser.add_argument('--sigma_threshold', type=float, default=0.05)
  parser.add_argument('--out', default=os.path.join(
      quality_bench.DEFAULT_DIR, 'serve_quality.json'))
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  return parser.parse_args(argv)


def load_params(path):
  """An npz of either package's quality bench -> (param tree of numpy
  arrays, warp alpha or None, time alpha)."""
  with np.load(path) as data:
    arrays = {k: data[k] for k in data.files}
  # The warp PE window is part of the trained function: rendering with
  # alpha 0 crushes every non-zero warp code.
  warp_alpha = (float(arrays['__warp_alpha__'])
                if '__warp_alpha__' in arrays else None)
  time_alpha = (float(arrays['__time_alpha__'])
                if '__time_alpha__' in arrays else 0.0)
  names = [k for k in arrays if not k.startswith('__')]
  tree = fused_mlp.unflatten_tree([tuple(k.split('/')) for k in names],
                                  [arrays[k] for k in names])
  return tree, warp_alpha, time_alpha


@dataclasses.dataclass
class Result:
  """The result file's dict and the occupancy grid's bake seconds."""
  result: Dict[str, Any]
  bake_seconds: float


def run(args: argparse.Namespace, config: configs.ModelConfig) -> Result:
  """Serves the npz's model, of architecture `config`, in the four modes."""
  device = resolve_device(args.device)
  tree, warp_alpha, time_alpha = load_params(args.params)
  datasource = datasets.from_config(
      {'type': 'nerfies', 'data_dir': args.scene_dir},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True, random_seed=0)
  params = interop.params_from_jax(tree, device)
  if warp_alpha is None:
    # An npz without alphas: the fully annealed window.
    warp_alpha = float(config.num_warp_freqs)
    print(f'params file has no __warp_alpha__; assuming fully-annealed '
          f'{warp_alpha}', flush=True)
  state = evaluation.RenderState(params, warp_alpha=warp_alpha,
                                 time_alpha=time_alpha)
  ids = dict(appearance_ids=datasource.appearance_ids,
             camera_ids=datasource.camera_ids,
             warp_ids=datasource.warp_ids,
             near=datasource.near, far=datasource.far)

  def build_model(coarse, fine):
    serve_config = dataclasses.replace(
        config, use_stratified_sampling=False, use_fused_mlp=False,
        use_fused_warp=True, num_coarse_samples=coarse,
        num_fine_samples=fine)
    model, _ = nerf.construct_nerf(serve_config, device=device, **ids)
    return model

  val_rays, val_rgb = quality_bench.load_view(datasource,
                                              datasource.val_ids[0])
  num_rays = int(np.prod(val_rgb.shape[:2]))

  # Occupancy box: the point cloud's bounds and a 20% margin (covers what
  # the warp reaches at these amplitudes).
  points = datasource.load_points()
  lo, hi = points.min(axis=0), points.max(axis=0)
  margin = 0.2 * (hi - lo).max() + 0.2
  model_full = build_model(128, 128)
  sigma_fn = occupancy.sigma_fn_from_params(params, model_full, level='fine')
  t0 = time.perf_counter()
  grid = occupancy.build_grid(
      sigma_fn, bbox_min=lo - margin, bbox_max=hi + margin,
      resolution=args.grid_resolution, sigma_threshold=args.sigma_threshold,
      device=device)
  occ_frac = float(grid.occupied.float().mean())
  bake_seconds = time.perf_counter() - t0
  print(f'grid baked in {bake_seconds:.1f}s, {100 * occ_frac:.1f}% '
        'occupied', flush=True)

  hd_camera = synthetic.make_orbit_camera(HD_THETA, image_size=HD_SIZE)
  hd_metadata = {'warp': 0, 'camera': 0, 'appearance': 0, 'time': 0.0}

  @torch.no_grad()
  def evaluate(tag, model, **render_kwargs):
    render_fn = evaluation.make_render_fn(model, device=device,
                                          **render_kwargs)
    evaluation.render_image(state, val_rays, render_fn,
                            chunk=args.chunk)  # warm-up
    out = evaluation.render_image(state, val_rays, render_fn,
                                  chunk=args.chunk)
    pred = np.clip(out['rgb'], 0, 1)
    ssim_value = quality_bench.ms_ssim(pred, val_rgb)
    rps = out['rays_per_sec']
    row = {'mode': tag, 'rays_per_sec': round(rps, 1),
           'psnr': round(quality_bench.psnr(pred, val_rgb), 3),
           'ms_ssim': (round(ssim_value, 4) if ssim_value is not None
                       else None)}
    if args.measure_1080p:
      evaluation.render_camera(state, hd_camera, hd_metadata, render_fn,
                               chunk=args.hd_chunk)  # warm-up
      hd = evaluation.render_camera(state, hd_camera, hd_metadata,
                                    render_fn, chunk=args.hd_chunk)
      row['measured_1080p_s'] = round(hd['render_time'], 3)
      row['hd_rays_per_sec'] = round(hd['rays_per_sec'], 1)
    else:
      row['projected_1080p_s'] = round(HD_SIZE[0] * HD_SIZE[1] / rps, 3)
    print(json.dumps(row), flush=True)
    return row

  rows: List[dict] = []
  for tag, (coarse, fine), keep in MODES:
    model = model_full if (coarse, fine) == (128, 128) else build_model(
        coarse, fine)
    kwargs = {} if keep is None else dict(occupancy=grid, keep_samples=keep)
    rows.append(evaluate(tag, model, **kwargs))

  result = {
      'scene': 'textured synthetic (quality_bench workload)',
      'image_rays': num_rays,
      'device': (torch.cuda.get_device_name(device)
                 if device.type == 'cuda' else 'cpu'),
      'grid': {'resolution': args.grid_resolution,
               'sigma_threshold': args.sigma_threshold,
               'occupied_fraction': round(occ_frac, 4)},
      'modes': rows,
  }
  out_path = pathlib.Path(args.out)
  out_path.parent.mkdir(parents=True, exist_ok=True)
  out_path.write_text(json.dumps(result, indent=2))
  print(f'wrote {args.out}', flush=True)
  return Result(result, bake_seconds)


def main(argv: Optional[Sequence[str]] = None) -> Result:
  args = parse_args(argv)
  return run(args, quality_bench.model_config())


if __name__ == '__main__':
  main()
