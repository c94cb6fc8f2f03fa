"""Entry points for a driver: the flagship forward and a data-parallel dry run.

The port's counterpart of __graft_entry__.py:

  - `entry(device)` returns (fn, args): `NerfModel.forward` of the
    gpu_vrig_paper model (SE(3) warp, camera metadata, 128 + 128
    samples, deterministic) at full width on 512 rays;
  - `dryrun_multichip(n, device)` starts `n` ranks through
    `parallel/mesh.py` (gloo on the CPU, NCCL on cards, one card a rank)
    that each take one data-parallel training step at tiny width with
    the elastic, background and warp-regularisation losses, then render
    an image (`render_image`) and a camera (`render_camera`) split over
    the ranks.

  python -m nerfies_tpu_torch.graft_entry [--device cpu]

Both run on the card unless told device='cpu'.
"""

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch import training
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.parallel import mesh

WARP_EXTRA = {'alpha': 6.0, 'time_alpha': 0.0}


def _flagship_config(**overrides) -> configs.ModelConfig:
  """The gpu_vrig_paper model: SE(3) warp, camera metadata, 128+128."""
  kwargs = dict(
      num_coarse_samples=128,
      num_fine_samples=128,
      nerf_trunk_depth=8,
      nerf_trunk_width=256,
      nerf_rgb_branch_depth=1,
      nerf_rgb_branch_width=128,
      num_nerf_point_freqs=8,
      num_nerf_viewdir_freqs=4,
      use_warp=True,
      warp_field_type='se3',
      num_warp_freqs=6,
      num_warp_features=8,
      use_camera_metadata=True,
      camera_metadata_dims=2,
      sigma_activation='softplus',
      use_stratified_sampling=False,
  )
  kwargs.update(overrides)
  return configs.ModelConfig(**kwargs)


def _fake_rays(batch_size: int, seed: int = 0) -> dict:
  """__graft_entry__._fake_rays's rays, as numpy arrays."""
  rng = np.random.RandomState(seed)
  directions = rng.randn(batch_size, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  return {
      'origins': np.zeros((batch_size, 3), np.float32),
      'directions': directions,
      'metadata': {
          'warp': np.zeros((batch_size, 1), np.uint32),
          'camera': np.zeros((batch_size, 1), np.uint32),
          'appearance': np.zeros((batch_size, 1), np.uint32),
          'time': np.zeros((batch_size, 1), np.float32),
      },
  }


def entry(device='cuda'):
  """Returns (fn, (params, rays)): the flagship forward on 512 rays."""
  device = resolve_device(device)
  model, params = nerf.construct_nerf(
      _flagship_config(), appearance_ids=(0,), camera_ids=(0, 1),
      warp_ids=tuple(range(8)), near=0.1, far=2.0,
      generator=torch.Generator().manual_seed(0), device=device)
  rays = utils.to_device(_fake_rays(512), device)

  def forward(params, rays_dict):
    with torch.no_grad():
      return model(params, utils.to_device(rays_dict, device),
                   WARP_EXTRA)

  return forward, (params, rays)


def _rank_step(device, n_devices: int) -> None:
  """One rank's part of the dry run (mesh.init already ran)."""
  config = _flagship_config(
      num_coarse_samples=8, num_fine_samples=8,
      nerf_trunk_depth=2, nerf_trunk_width=32,
      nerf_rgb_branch_depth=1, nerf_rgb_branch_width=16,
      num_nerf_point_freqs=2, num_nerf_viewdir_freqs=1, num_warp_freqs=2,
      warp_kwargs={'trunk_depth': 2, 'trunk_width': 16},
      use_stratified_sampling=True)
  model, params = nerf.construct_nerf(
      config, appearance_ids=(0,), camera_ids=(0,), warp_ids=(0, 1),
      near=0.1, far=2.0, generator=torch.Generator().manual_seed(0),
      device=device, use_warp_jacobian=True, use_weights=True)
  batch_size = 2 * n_devices
  train_config = configs.TrainConfig(
      batch_size=batch_size, use_elastic_loss=True,
      elastic_reduce_method='weight', use_background_loss=True,
      use_warp_reg_loss=True, warp_reg_loss_weight=1e-2)
  step_fn = training.make_train_step(model, train_config, device)
  state = training.create_train_state(params, warp_alpha=2.0)
  scalar_params = training.ScalarParams(
      learning_rate=1e-3, elastic_loss_weight=1e-3,
      background_loss_weight=1.0,
      warp_reg_loss_weight=train_config.warp_reg_loss_weight)

  batch = _fake_rays(batch_size)
  batch['rgb'] = np.random.RandomState(1).uniform(
      size=(batch_size, 3)).astype(np.float32)
  batch['background_points'] = np.random.RandomState(2).randn(
      4 * n_devices, 3).astype(np.float32)
  # Each rank takes its contiguous rows of the global batch.
  rows = lambda n: mesh.local_batch_slice(n)
  local = {k: (v[rows(len(v))] if not isinstance(v, dict) else
               {mk: mv[rows(len(mv))] for mk, mv in v.items()})
           for k, v in batch.items()}
  state, stats = step_fn(training.step_generator(0, 0, device), state,
                         local, scalar_params)
  loss = float(stats['coarse']['loss/total'])
  if not np.isfinite(loss):
    raise FloatingPointError(f'non-finite loss from the step: {loss}')
  if state.step != 1:
    raise RuntimeError(f'the step left the state at step {state.step}')

  # The whole-image render, every chunk split over the ranks.
  render_fn = evaluation.make_render_fn(model, device=device)
  rays = _fake_rays(4 * n_devices)
  rays_hw = {
      'origins': rays['origins'].reshape(2, 2 * n_devices, 3),
      'directions': rays['directions'].reshape(2, 2 * n_devices, 3),
      'metadata': {k: v.reshape(2, 2 * n_devices, 1)
                   for k, v in rays['metadata'].items()},
  }
  render_state = evaluation.RenderState(state.params, warp_alpha=2.0)
  out = evaluation.render_image(render_state, rays_hw, render_fn,
                                chunk=2 * n_devices)
  if out['rgb'].shape != (2, 2 * n_devices, 3):
    raise RuntimeError(f'render shape {out["rgb"].shape}')
  if not np.isfinite(out['rgb']).all():
    raise FloatingPointError('non-finite render')
  # Rays made on the device from a camera.
  camera = synthetic.make_orbit_camera(0.3, image_size=(4 * n_devices, 2))
  metadata_ids = {'warp': 0, 'camera': 0, 'appearance': 0, 'time': 0.0}
  cam_out = evaluation.render_camera(render_state, camera, metadata_ids,
                                     render_fn, chunk=2 * n_devices)
  if cam_out['rgb'].shape != (2, 4 * n_devices, 3):
    raise RuntimeError(f'camera render shape {cam_out["rgb"].shape}')
  if not np.isfinite(cam_out['rgb']).all():
    raise FloatingPointError('non-finite camera render')


def _rank_main(rank: int, n_devices: int, device_type: str, store: str):
  device = (torch.device('cuda', rank) if device_type == 'cuda'
            else torch.device('cpu'))
  if device.type == 'cpu':
    torch.set_num_threads(1)
  device = mesh.init(device, init_method=f'file://{store}', rank=rank,
                     world_size=n_devices)
  try:
    _rank_step(device, n_devices)
  finally:
    mesh.shutdown()


def dryrun_multichip(n_devices: int, device='cuda') -> None:
  """One data-parallel step and two renders on `n_devices` ranks.

  Raises:
    RuntimeError: too few cards, or a rank failed (its error is raised
      by torch.multiprocessing).
  """
  device_type = torch.device(device).type
  if device_type == 'cuda':
    resolve_device('cuda')
    if torch.cuda.device_count() < n_devices:
      raise RuntimeError(f'Need {n_devices} cards for the dry run, found '
                         f'{torch.cuda.device_count()}.')
  with tempfile.TemporaryDirectory() as tmp:
    torch.multiprocessing.spawn(
        _rank_main, args=(n_devices, device_type, os.path.join(tmp, 'store')),
        nprocs=n_devices, join=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  fn, fn_args = entry(args.device)
  out = fn(*fn_args)
  print('entry ok:', {level: tuple(v['rgb'].shape)
                      for level, v in out.items()})
  count = (torch.cuda.device_count()
           if torch.device(args.device).type == 'cuda' else 2)
  dryrun_multichip(count, args.device)
  print('dryrun_multichip ok')


if __name__ == '__main__':
  main()
