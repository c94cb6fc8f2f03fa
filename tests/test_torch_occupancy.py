"""The port's occupancy grid and culled render against the JAX package's.

The bake, the grid's query and dilation, the stable top-K selection, the
density query through the NeRF MLP and the culled `render_rays`, on the
CPU: the JAX side runs its Pallas kernels in the interpreter, the port
the plain versions of its kernels. Model params are one JAX tree carried
across by interop (tests/test_torch_fast_render.py `_build`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_fast_render as tfr

from nerfies_tpu import fast_render as jax_fast_render
from nerfies_tpu import occupancy as jax_occupancy
from nerfies_tpu.ops import rendering as jax_rendering
from nerfies_tpu_torch import fast_render
from nerfies_tpu_torch import occupancy
from nerfies_tpu_torch.ops import rendering

# The density tolerance of the bf16 MLP (tests/test_fused_mlp.py).
SIGMA_ATOL = SIGMA_RTOL = 0.05
# Voxels whose occupancy may differ between two bakes of one model: a
# density within bf16 rounding of the threshold may fall on either side.
MAX_FLIPPED_VOXELS = 0.001


def _sphere(xp, center=(0.0, 0.0, 1.5), radius=0.4, height=25.0):
  """A sphere of constant density, as tests/test_occupancy.py's, in xp."""

  def sigma_fn(points):
    d = ((points - xp.asarray(center, dtype=points.dtype)) ** 2).sum(-1)
    return xp.where(d < radius ** 2, height, 0.0)

  return sigma_fn


def _torch_sphere(**kwargs):
  fn = _sphere(torch, **kwargs)
  return lambda points: fn(points).float()


def _both_grids(jax_fn, torch_fn, **kwargs):
  want = jax_occupancy.build_grid(jax_fn, **kwargs)
  got = occupancy.build_grid(torch_fn, device='cpu', **kwargs)
  return got, want


@pytest.mark.parametrize('dilate', [False, True])
def test_build_grid_and_query_match_jax(dilate):
  kwargs = dict(bbox_min=(-1, -1, 0), bbox_max=(1, 1, 3), resolution=32,
                sigma_threshold=1.0, dilate=dilate, chunk=5000)
  got, want = _both_grids(_sphere(jnp), _torch_sphere(), **kwargs)
  np.testing.assert_array_equal(got.occupied.numpy(),
                                np.asarray(want.occupied))
  np.testing.assert_array_equal(got.bbox_min.numpy(),
                                np.asarray(want.bbox_min))
  assert got.resolution == want.resolution == 32
  # Points inside, outside and far outside the box (clamped).
  rng = np.random.RandomState(0)
  points = rng.uniform(-2.0, 4.0, (5, 40, 3)).astype(np.float32)
  points[0, :3] = [[0.0, 0.0, 1.5], [0.9, 0.9, 0.1], [10.0, 10.0, 10.0]]
  got_occ = got.query(torch.from_numpy(points)).numpy()
  np.testing.assert_array_equal(got_occ,
                                np.asarray(want.query(jnp.asarray(points))))
  assert got_occ[0, 0] and not got_occ[0, 1] and not got_occ[0, 2]


def test_dilation_matches_jax_and_is_conservative():
  center = (0.5, 0.5, 0.5)
  kwargs = dict(bbox_min=(0, 0, 0), bbox_max=(1, 1, 1), resolution=8,
                sigma_threshold=1.0)
  raw = {}
  for dilate in (False, True):
    got, want = _both_grids(_sphere(jnp, center, 0.12, 100.0),
                            _torch_sphere(center=center, radius=0.12,
                                          height=100.0),
                            dilate=dilate, **kwargs)
    np.testing.assert_array_equal(got.occupied.numpy(),
                                  np.asarray(want.occupied))
    raw[dilate] = got.occupied.numpy()
  assert 1 <= raw[False].sum() < raw[True].sum()
  assert np.all(~raw[False] | raw[True])


def _occupancy_cases():
  fixed = np.array([[0, 1, 0, 1, 1, 0, 1, 0],
                    [1, 1, 1, 1, 1, 1, 1, 1],
                    [0, 0, 0, 0, 0, 0, 0, 0]], bool)
  rng = np.random.RandomState(3)
  return np.concatenate([fixed, rng.uniform(size=(61, 8)) < 0.4])


@pytest.mark.parametrize('keep_last', [True, False])
@pytest.mark.parametrize('k', [3, 5, 8, 11])
def test_select_occupied_matches_jax(k, keep_last):
  occ = _occupancy_cases()
  z = np.broadcast_to(np.arange(8.0, dtype=np.float32), occ.shape)
  want = np.asarray(jax_occupancy.select_occupied(
      jnp.asarray(occ), jnp.asarray(z), k, keep_last=keep_last))
  got = occupancy.select_occupied(torch.from_numpy(occ), k,
                                  keep_last=keep_last).numpy()
  assert got.shape == want.shape == (occ.shape[0], min(k, 8))
  np.testing.assert_array_equal(got, want)
  if k < 8 and keep_last:
    assert (got[:, -1] == 7).all()


def test_culled_compositing_matches_jax_and_the_full_ladder():
  """Compositing the kept subset with the gathered ladder spacing equals
  the full compositing where every dropped sample has zero density."""
  rng = np.random.RandomState(0)
  b, s, k = 4, 16, 6
  z_vals = np.sort(rng.uniform(0.5, 3.0, (b, s)), axis=-1).astype(np.float32)
  occ = np.zeros((b, s), bool)
  for i in range(b):
    occ[i, rng.choice(s, size=4, replace=False)] = True
  sigma = (occ * rng.uniform(5, 30, (b, s))).astype(np.float32)
  rgb = rng.uniform(size=(b, s, 3)).astype(np.float32)
  directions = rng.randn(b, 3).astype(np.float32)
  kw = dict(use_white_background=False, sample_at_infinity=False)

  def composite(ops, occ_lib, xp, idx):
    z_k, rgb_k, d_k = occ_lib.gather_samples(
        xp(z_vals), xp(rgb), idx, ops.ladder_dists(xp(z_vals), False))
    sigma_k = xp(sigma)[np.arange(b)[:, None], idx]
    return ops.volumetric_rendering(rgb_k, sigma_k, z_k, xp(directions),
                                    dists=d_k, **kw)

  t = torch.from_numpy
  got = composite(rendering, occupancy, t,
                  occupancy.select_occupied(t(occ), k))
  want = composite(jax_rendering, jax_occupancy, jnp.asarray,
                   jax_occupancy.select_occupied(jnp.asarray(occ), None, k))
  full = rendering.volumetric_rendering(t(rgb), t(sigma), t(z_vals),
                                        t(directions), **kw)
  for key, atol in (('rgb', 1e-5), ('acc', 1e-5), ('depth', 1e-4)):
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got[key].numpy(), full[key].numpy(),
                               atol=atol, err_msg=key)


@pytest.fixture(scope='module')
def model_pair():
  return tfr._build('se3')


def test_sigma_fn_from_params_matches_jax(model_pair):
  jax_model, jax_params, model, params = model_pair
  points = np.random.RandomState(1).uniform(-3, 3, (777, 3)).astype(
      np.float32)
  for level in ('coarse', 'fine'):
    want = jax_occupancy.sigma_fn_from_params(
        jax_params, jax_model, level=level, interpret=True)(
            jnp.asarray(points))
    got = occupancy.sigma_fn_from_params(params, model, level=level)(
        torch.from_numpy(points))
    assert got.shape == (777,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SIGMA_ATOL, rtol=SIGMA_RTOL,
                               err_msg=level)


def _model_grids(model_pair, threshold):
  jax_model, jax_params, model, params = model_pair
  kwargs = dict(bbox_min=(-3, -3, -3), bbox_max=(3, 3, 3), resolution=24,
                sigma_threshold=threshold, chunk=4096)
  return _both_grids(
      jax_occupancy.sigma_fn_from_params(jax_params, jax_model,
                                         interpret=True),
      occupancy.sigma_fn_from_params(params, model), **kwargs)


# A threshold above the model's median density (0.46 on this grid): about
# half of the voxels stay occupied after dilation, so culling drops
# occupied and empty candidates alike.
_THRESHOLD = 0.6


def test_grid_baked_from_a_model_matches_jax(model_pair):
  got, want = _model_grids(model_pair, _THRESHOLD)
  got, want = got.occupied.numpy(), np.asarray(want.occupied)
  assert 0.05 < want.mean() < 0.95, want.mean()
  assert (got != want).mean() <= MAX_FLIPPED_VOXELS


def _state_rays(seed):
  rays = tfr._rays(batch=24, seed=seed)
  return rays, tfr._torch_rays(rays)


def test_culled_render_matches_jax(model_pair):
  """One grid, JAX's, culls both renders to (6, 10) of (8, 8 + 8)."""
  jax_model, jax_params, model, params = model_pair
  _, want_grid = _model_grids(model_pair, _THRESHOLD)
  grid = occupancy.OccupancyGrid(
      occupied=torch.from_numpy(np.array(want_grid.occupied)),
      bbox_min=torch.from_numpy(np.array(want_grid.bbox_min)),
      bbox_max=torch.from_numpy(np.array(want_grid.bbox_max)))
  rays, torch_rays = _state_rays(7)
  keep = (6, 10)
  want = jax_fast_render.render_rays(
      jax_params, jax.tree.map(jnp.asarray, rays), tfr._WARP_EXTRA,
      jax_model, interpret=True, mlp='pallas', occupancy=want_grid,
      keep_samples=keep, return_weights=True)
  got = fast_render.render_rays(params, torch_rays, tfr._WARP_EXTRA, model,
                                occupancy=grid, keep_samples=keep,
                                return_weights=True)
  assert got['coarse']['weights'].shape == (24, 6)
  assert got['fine']['weights'].shape == (24, 10)
  for level in ('coarse', 'fine'):
    assert set(got[level]) == set(want[level])
    for key in ('rgb', 'depth', 'med_depth', 'acc', 'weights'):
      np.testing.assert_allclose(
          got[level][key].numpy(), np.asarray(want[level][key]),
          atol=tfr.ATOL, rtol=tfr.RTOL, err_msg=f'{level}/{key}')


def test_all_occupied_grid_with_every_sample_kept_changes_nothing(model_pair):
  _, _, model, params = model_pair
  _, rays = _state_rays(8)
  grid = occupancy.OccupancyGrid(
      occupied=torch.ones((8, 8, 8), dtype=torch.bool),
      bbox_min=torch.full((3,), -5.0), bbox_max=torch.full((3,), 5.0))
  want = fast_render.render_rays(params, rays, tfr._WARP_EXTRA, model)
  got = fast_render.render_rays(
      params, rays, tfr._WARP_EXTRA, model, occupancy=grid,
      keep_samples=(model.num_coarse_samples,
                    model.num_coarse_samples + model.num_fine_samples))
  for level in want:
    for key in ('rgb', 'depth', 'med_depth', 'acc'):
      np.testing.assert_allclose(got[level][key].numpy(),
                                 want[level][key].numpy(), atol=1e-5,
                                 rtol=0, err_msg=f'{level}/{key}')
