"""The benchmark's counts of operations against FlopCounterMode over the
plain reference, at the configurations' widths and a tiny number of rays."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark import manifest
from benchmark import weights
from benchmark.reference import nerfies as reference

CONFIGS = ['vrig_paper', 'fullhd']


def _setup(config_name, coarse=4, fine=4):
  cell = manifest.load_cell({'vrig_paper': 'vrig_paper.train',
                             'fullhd': 'fullhd.train'}[config_name])
  model = copy.deepcopy(cell.config['model'])
  model.update(num_coarse_samples=coarse, num_fine_samples=fine)
  ids = {'warp': 3, 'camera': 2, 'appearance': 3}
  ids = {k: v for k, v in ids.items()
         if k == 'warp' or model[f'use_{k}_metadata']}
  params = weights.make(model, ids, 5, 'cpu')
  return model, params, reference.Reference(model, 1.0, 4.0), ids


def _flops(fn):
  with FlopCounterMode(display=False) as counter:
    fn()
  return counter.get_total_flops()


def _rays(n, ids):
  g = torch.Generator().manual_seed(0)
  d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
  metadata = {k: torch.zeros(n, 1, dtype=torch.int64) for k in ids}
  return torch.randn(n, 3, generator=g), d, metadata


@pytest.mark.parametrize('config_name', CONFIGS)
def test_nerf_mlp_counts(config_name):
  model, params, ref, ids = _setup(config_name)
  rays, samples = 3, 5
  points = torch.randn(rays, samples, 3)
  _, d, metadata = _rays(rays, ids)
  condition = ref.conditions(params, d, metadata)
  got = _flops(lambda: ref.nerf_mlp(params['nerf_mlps_coarse'], points,
                                    condition))
  assert got == (rays * samples * counts.nerf_point_flops(model)
                 + rays * counts.nerf_ray_flops(model))


@pytest.mark.parametrize('config_name', CONFIGS)
def test_nerf_mlp_backward_is_twice_the_forward(config_name):
  model, params, ref, ids = _setup(config_name)
  points = torch.randn(4, 6, 3, requires_grad=True)
  condition = torch.zeros(4, 1, counts.condition_dims(model))
  leaves = [v.requires_grad_(True) for v in
            weights.flatten(params['nerf_mlps_coarse']).values()]

  def step():
    rgb, alpha = ref.nerf_mlp(params['nerf_mlps_coarse'], points, condition)
    torch.autograd.grad(rgb.sum() + alpha.sum(), [points] + leaves)

  total = _flops(step)
  forward = 4 * 6 * counts.nerf_point_flops(model) + 4 * counts.nerf_ray_flops(
      model)
  # The condition is no leaf here: its dX product is the one missing.
  assert total == 3 * forward - 4 * counts.nerf_ray_flops(model)


@pytest.mark.parametrize('config_name', CONFIGS)
def test_warp_counts_with_and_without_tangents(config_name):
  model, params, ref, ids = _setup(config_name)
  points = torch.randn(3, 5, 3)
  warp_ids = torch.zeros(3, 1, dtype=torch.int64)
  primal = _flops(lambda: ref.warp(params, points, warp_ids, 6.0))
  assert primal == 15 * counts.warp_point_flops(model) + 3 * counts.warp_ray_flops(
      model)
  jac = _flops(lambda: ref.warp(params, points, warp_ids, 6.0, True))
  assert jac == primal + 3 * 15 * counts.warp_point_flops(model)


@pytest.mark.parametrize('config_name', CONFIGS)
def test_render_and_step_counts(config_name):
  model, params, ref, ids = _setup(config_name)
  origins, d, metadata = _rays(7, ids)
  got = _flops(lambda: ref.render(params, origins, d, metadata, 6.0))
  assert got == 7 * counts.render_ray_flops(model)
  batch = {'origins': origins, 'directions': d, 'metadata': metadata,
           'rgb': torch.rand(7, 3)}
  g = torch.Generator().manual_seed(1)
  u_c = torch.rand(7, model['num_coarse_samples'], generator=g)
  u_f = torch.rand(7, model['num_fine_samples'], generator=g)
  points = torch.randn(9, 3, generator=g)
  warp_ids = torch.zeros(9, 1, dtype=torch.int64)
  with torch.no_grad():
    step = _flops(lambda: (
        ref.ray_losses(params, batch, u_c, u_f, 6.0, 1e-3),
        ref.background_loss(params, points, warp_ids, torch.zeros(9, 3), 6.0,
                            1e-3)))
  assert step == counts.step_forward_flops(model, 7, 9)
  assert counts.step_flops(model, 7, 9) == 3 * step


@pytest.mark.parametrize('config_name', CONFIGS)
def test_the_nerf_kernels_are_compute_bound(config_name):
  model = manifest.load_cell(f'{config_name}.train').config['model']
  name = 'NVIDIA H100 80GB HBM3'
  for fn in (counts.nerf_forward_least_s, counts.nerf_backward_least_s):
    seconds, bound = fn(model, 1 << 20, name)
    assert bound == 'compute' and seconds > 0
  assert counts.peak('some other card') is None


def test_published_step_sizes():
  """The step and ray counts quoted in PERF.md."""
  vrig = manifest.load_cell('vrig_paper.train').config
  fullhd = manifest.load_cell('fullhd.train').config
  assert counts.step_flops(vrig['model'], 6144, 16384) == pytest.approx(
      10.89e12, rel=1e-3)
  assert counts.step_flops(fullhd['model'], 4096, 16384) == pytest.approx(
      14.75e12, rel=1e-3)
  assert counts.render_ray_flops(vrig['model']) == pytest.approx(519.6e6,
                                                                 rel=1e-3)
