"""The eval slice on a card against the same code on the CPU.

`render_camera`, the occupancy bake and its density query and the culled
render launch the serving kernels on the card and run their plain
versions on the CPU, from one set of params; MS-SSIM and LPIPS run in
float64 on both. The model is small (NeRF trunk 4 x 32, rgb branch 128,
SE(3) warp 6 x 128: widths the kernels are built for) with 8 + 8 samples.

Marked `cuda`: they skip without a card. This file imports no JAX, so it
also runs on a machine without it:

  python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
      tests/test_torch_eval_cuda.py
"""

import numpy as np
import pytest
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import fast_render
from nerfies_tpu_torch import lpips
from nerfies_tpu_torch import occupancy
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import ssim

# The render tolerance of tests/test_fast_render.py, and the bf16 one of
# tests/test_fused_mlp.py for densities.
RENDER_ATOL, RENDER_RTOL = 0.02, 0.05
SIGMA_ATOL = SIGMA_RTOL = 0.05
_METADATA = {'warp': 1, 'appearance': 0, 'camera': 0}


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels have no CPU mode')
  return torch.device('cuda')


def _tree_to(tree, device):
  return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
          for k, v in tree.items()}


def _models(device):
  """(model, CPU params, card params) of one seeded draw."""
  config = configs.ModelConfig(
      num_coarse_samples=8, num_fine_samples=8, nerf_trunk_depth=4,
      nerf_trunk_width=32, nerf_rgb_branch_width=128, nerf_skips=(2,),
      use_warp=True, warp_field_type='se3', use_appearance_metadata=True,
      use_camera_metadata=True, use_stratified_sampling=False)
  model, params = nerf.construct_nerf(
      config, appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
      near=1.5, far=4.5, generator=torch.Generator().manual_seed(0),
      device='cpu')
  return model, params, _tree_to(params, device)


def _camera():
  cam = synthetic.make_orbit_camera(0.7, image_size=(24, 20))
  cam.radial_distortion = np.array([0.05, -0.02, 0.01], np.float32)
  cam.tangential_distortion = np.array([0.01, -0.005], np.float32)
  return cam


def _close(got, want, atol, rtol):
  for key in ('rgb', 'depth', 'acc'):
    np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=rtol,
                               err_msg=key)


@pytest.mark.cuda
def test_render_camera_on_card_matches_cpu(cuda_device):
  model, params, card_params = _models(cuda_device)
  got = evaluation.render_camera(
      evaluation.RenderState(card_params, warp_alpha=2.0), _camera(),
      _METADATA, evaluation.make_render_fn(model, device=cuda_device),
      chunk=100)
  want = evaluation.render_camera(
      evaluation.RenderState(params, warp_alpha=2.0), _camera(), _METADATA,
      evaluation.make_render_fn(model, device='cpu'), chunk=100)
  assert got['rgb'].shape == (20, 24, 3)
  _close(got, want, RENDER_ATOL, RENDER_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('level', ['coarse', 'fine'])
def test_sigma_fn_on_card_matches_cpu(cuda_device, level):
  model, params, card_params = _models(cuda_device)
  points = torch.from_numpy(np.random.RandomState(1).uniform(
      -3, 3, (4099, 3)).astype(np.float32))
  got = occupancy.sigma_fn_from_params(card_params, model, level)(
      points.to(cuda_device))
  want = occupancy.sigma_fn_from_params(params, model, level)(points)
  np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                             atol=SIGMA_ATOL, rtol=SIGMA_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('dilate', [False, True])
def test_build_grid_on_card_matches_cpu(cuda_device, dilate):
  center = torch.tensor([0.1, -0.2, 1.5])

  def sphere(points):
    d = ((points - center.to(points.device)) ** 2).sum(-1)
    return torch.where(d < 0.4 ** 2, 25.0, 0.0)

  kwargs = dict(bbox_min=(-1, -1, 0), bbox_max=(1, 1, 3), resolution=32,
                sigma_threshold=1.0, dilate=dilate, chunk=5000)
  got = occupancy.build_grid(sphere, device=cuda_device, **kwargs)
  want = occupancy.build_grid(sphere, device='cpu', **kwargs)
  assert got.occupied.device.type == cuda_device.type
  np.testing.assert_array_equal(got.occupied.cpu().numpy(),
                                want.occupied.numpy())
  points = torch.from_numpy(np.random.RandomState(2).uniform(
      -2, 4, (999, 3)).astype(np.float32))
  np.testing.assert_array_equal(got.query(points.to(cuda_device)).cpu(),
                                want.query(points))


@pytest.mark.cuda
def test_culled_render_on_card(cuda_device):
  """An all-occupied grid keeping every sample changes nothing on the card;
  a grid baked from the model culls to (4, 8) with finite outputs."""
  model, _, card_params = _models(cuda_device)
  rng = np.random.RandomState(3)
  directions = rng.normal(size=(300, 3)).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  rays = {'origins': torch.zeros((300, 3), device=cuda_device),
          'directions': torch.from_numpy(directions).to(cuda_device),
          'metadata': {k: torch.full((300, 1), v, device=cuda_device)
                       for k, v in _METADATA.items()}}
  extra = {'alpha': 2.0, 'time_alpha': 0.0}
  full = fast_render.render_rays(card_params, rays, extra, model)
  every = occupancy.OccupancyGrid(
      occupied=torch.ones((8, 8, 8), dtype=torch.bool, device=cuda_device),
      bbox_min=torch.full((3,), -10.0, device=cuda_device),
      bbox_max=torch.full((3,), 10.0, device=cuda_device))
  same = fast_render.render_rays(card_params, rays, extra, model,
                                 occupancy=every, keep_samples=(8, 16))
  for level in full:
    for key in ('rgb', 'depth', 'med_depth', 'acc'):
      torch.testing.assert_close(same[level][key], full[level][key],
                                 atol=1e-5, rtol=0)
  sigma_fn = occupancy.sigma_fn_from_params(card_params, model)
  grid = occupancy.build_grid(sigma_fn, bbox_min=(-5, -5, -5),
                              bbox_max=(5, 5, 5), resolution=16,
                              sigma_threshold=0.7, device=cuda_device)
  culled = fast_render.render_rays(card_params, rays, extra, model,
                                   occupancy=grid, keep_samples=(4, 8),
                                   return_weights=True)
  assert culled['coarse']['weights'].shape == (300, 4)
  assert culled['fine']['weights'].shape == (300, 8)
  for level in culled.values():
    for value in level.values():
      assert torch.isfinite(value).all()


@pytest.mark.cuda
def test_ssim_and_lpips_on_card_match_cpu(cuda_device):
  yy, xx = np.mgrid[0:192, 0:192].astype(np.float32) / 192.0
  img0 = np.stack([0.6 + 0.01 * xx, 0.6 + 0.01 * yy,
                   np.full_like(xx, 0.6)], axis=-1)
  img1 = np.clip(img0 + 1e-3 * np.random.RandomState(4).randn(192, 192, 3),
                 0, 1).astype(np.float32)
  want = float(ssim.multiscale_ssim(img0, img1))
  got = float(ssim.multiscale_ssim(torch.from_numpy(img0).to(cuda_device),
                                   torch.from_numpy(img1).to(cuda_device)))
  assert got <= 1.0 + 1e-6
  np.testing.assert_allclose(got, want, atol=1e-9)
  rng = np.random.RandomState(5)
  a = rng.uniform(size=(64, 80, 3)).astype(np.float32)
  b = np.clip(a + 0.1 * rng.randn(64, 80, 3), 0, 1).astype(np.float32)
  np.testing.assert_allclose(lpips.LPIPS(device=cuda_device)(a, b),
                             lpips.LPIPS(device='cpu')(a, b), rtol=1e-6)
