#!/usr/bin/env python3
"""Renders a quality bench fit through each render route and prints the
PSNR and MS-SSIM of each: what the route costs in quality on one fit.

It loads the params that `python -m nerfies_tpu_torch.quality_bench
--save_params` writes and renders the scene's first val view and first
train view (the curve's two views) at 128 + 128 samples through:

  serving_kernels   the serving kernels (bf16), as the curve's evals do;
  plain_bf16        NerfModel.forward in bf16 (fast='off');
  plain_float32     NerfModel.forward in float32;
  culled_bench_box  the serving kernels culled to 32 + 48 samples by an
                    occupancy grid (128^3) over serve_bench's box (the
                    point cloud's bounds and a margin);
  culled_env_box    the same over a box that holds the scene's
                    environment sphere (radius synthetic.ENV_RADIUS).

  python3 scripts/render_routes.py --params quality_params.npz \\
      --scene_dir SCENE

The scene is the quality bench's (written to --scene_dir with its
defaults if absent). Prints the card's name and power limit on a card,
then one JSON line a route. Imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerfies_tpu_torch import datasets  # pylint: disable=g-import-not-at-top
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import serve_bench
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf

KEEP_SAMPLES = (32, 48)


@torch.no_grad()
def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--params', required=True)
  parser.add_argument('--scene_dir', default=os.path.join(
      quality_bench.DEFAULT_DIR, 'scene'))
  parser.add_argument('--chunk', type=int, default=8192)
  parser.add_argument('--grid_resolution', type=int, default=128)
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  args = parser.parse_args(argv)
  device = torch.device(args.device)
  if device.type == 'cuda':
    print(', '.join(quality_bench.card_label()))
  scene_args = quality_bench.parse_args(['--scene_dir', args.scene_dir])
  quality_bench.write_scene(scene_args)
  datasource = datasets.from_config(
      {'type': 'nerfies', 'data_dir': args.scene_dir},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True, random_seed=0)
  tree, warp_alpha, time_alpha = serve_bench.load_params(args.params)
  params = interop.params_from_jax(tree, device)
  state = evaluation.RenderState(params, warp_alpha=warp_alpha,
                                 time_alpha=time_alpha)
  ids = dict(appearance_ids=datasource.appearance_ids,
             camera_ids=datasource.camera_ids,
             warp_ids=datasource.warp_ids,
             near=datasource.near, far=datasource.far)
  config = dataclasses.replace(
      quality_bench.model_config(), use_stratified_sampling=False,
      use_fused_mlp=False, use_fused_warp=True)
  model, _ = nerf.construct_nerf(config, device=device, **ids)
  model_f32, _ = nerf.construct_nerf(
      dataclasses.replace(config, use_bfloat16=False), device=device, **ids)
  views = {'val': quality_bench.load_view(datasource, datasource.val_ids[0]),
           'train_view': quality_bench.load_view(datasource,
                                                 datasource.train_ids[0])}

  points = datasource.load_points()
  lo, hi = points.min(axis=0), points.max(axis=0)
  margin = 0.2 * (hi - lo).max() + 0.2
  env = synthetic.ENV_RADIUS * 1.05

  def culled(bbox_min, bbox_max):
    box = argparse.Namespace(grid_resolution=args.grid_resolution,
                             sigma_threshold=0.05)
    grid = serve_bench.bake_grid(params, model, bbox_min, bbox_max, box,
                                 device)
    return dict(occupancy=grid, keep_samples=KEEP_SAMPLES), float(
        grid.occupied.float().mean())

  bench_kwargs, bench_occupied = culled(lo - margin, hi + margin)
  env_kwargs, env_occupied = culled(np.full(3, -env), np.full(3, env))
  routes = (
      ('serving_kernels', model, {}, None),
      ('plain_bf16', model, dict(fast='off'), None),
      ('plain_float32', model_f32, dict(fast='off'), None),
      ('culled_bench_box', model, bench_kwargs, bench_occupied),
      ('culled_env_box', model, env_kwargs, env_occupied),
  )
  for name, route_model, kwargs, occupied in routes:
    render_fn = evaluation.make_render_fn(route_model, device=device,
                                          **kwargs)
    row = {'route': name}
    if occupied is not None:
      row['occupied_fraction'] = round(occupied, 4)
    for view, (rays, rgb) in views.items():
      pred = np.clip(evaluation.render_image(
          state, rays, render_fn, chunk=args.chunk)['rgb'], 0, 1)
      row[f'{view}_psnr'] = round(quality_bench.psnr(pred, rgb), 5)
      ssim_value = quality_bench.ms_ssim(pred, rgb)
      row[f'{view}_ms_ssim'] = (round(ssim_value, 6)
                                if ssim_value is not None else None)
    print(json.dumps(row), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
