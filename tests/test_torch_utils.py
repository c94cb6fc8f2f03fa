"""The port's utils.py against nerfies_tpu.utils on the same inputs.

The interpolations run the same numpy and scipy, so they agree to 1e-12;
the tensor helpers are held against JAX's on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu import utils as jax_utils
from nerfies_tpu.datasets import synthetic as jax_synthetic
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.datasets import synthetic
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-12


@pytest.mark.parametrize('method', ['spline', 'linear'])
@pytest.mark.parametrize('as_list', [False, True])
def test_interpolate_codes_matches_jax(method, as_list):
  codes = np.random.RandomState(0).randn(5, 8).astype(np.float32)
  if as_list:
    codes = list(codes)
  got = utils.interpolate_codes(codes, num_samples=17, method=method)
  want = jax_utils.interpolate_codes(codes, num_samples=17, method=method)
  assert got.dtype == want.dtype == np.float32
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
  with pytest.raises(ValueError):
    utils.interpolate_codes(codes, 3, method='cubic')


def test_interpolate_cameras_matches_jax():
  thetas = (0.0, 0.4, 1.1, 1.5)
  got = utils.interpolate_cameras(
      [synthetic.make_orbit_camera(t) for t in thetas], num_samples=9)
  want = jax_utils.interpolate_cameras(
      [jax_synthetic.make_orbit_camera(t) for t in thetas], num_samples=9)
  assert len(got) == len(want) == 9
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.orientation, b.orientation, atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(a.position, b.position, atol=ATOL, rtol=0)
    np.testing.assert_allclose(a.focal_length, b.focal_length, atol=ATOL)


@pytest.mark.parametrize('size', [7, 8])
def test_robust_whiten_matches_jax(size):
  x = np.random.RandomState(size).randn(size, 3).astype(np.float32)
  x[1, 2] = np.nan
  got = utils.robust_whiten(torch.from_numpy(x)).numpy()
  want = np.asarray(jax_utils.robust_whiten(jnp.asarray(x)))
  np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
  assert np.isnan(got[1, 2])


def test_small_helpers_match_jax():
  for step in (0, 1234, 100000, 250000):
    assert utils.learning_rate_decay(step) == jax_utils.learning_rate_decay(
        step)
    assert (utils.learning_rate_decay(step, 1e-3, 5000, 0.5)
            == jax_utils.learning_rate_decay(step, 1e-3, 5000, 0.5))
  v = np.asarray([3.0, -4.0, 12.0])
  np.testing.assert_array_equal(utils.normalize(v), jax_utils.normalize(v))
  feature = np.arange(6, dtype=np.float32).reshape(1, 6)
  np.testing.assert_array_equal(
      utils.broadcast_feature_to(torch.from_numpy(feature), (4, 5, 3)).numpy(),
      np.asarray(jax_utils.broadcast_feature_to(jnp.asarray(feature),
                                                (4, 5, 3))))
  rays = np.zeros((4, 5, 3), np.float32)
  got = utils.metadata_like(torch.from_numpy(rays), 7)
  want = np.asarray(jax_utils.metadata_like(jnp.asarray(rays), 7))
  assert got.dtype == torch.int64 and want.dtype == np.uint32
  np.testing.assert_array_equal(got.numpy(), want)
  trees = [{'a': np.full(3, i), 'b': {'c': np.zeros((2, 2)) + i}}
           for i in range(4)]
  got, want = utils.tree_collate(trees), jax_utils.tree_collate(trees)
  np.testing.assert_array_equal(got['a'], want['a'])
  np.testing.assert_array_equal(got['b']['c'], want['b']['c'])


def test_to_device_and_print_time(capsys):
  tree = {'x': np.ones((2, 3), np.float64),
          'm': {'ids': np.arange(3, dtype=np.uint32)}, 't': torch.ones(2),
          'list': [1.5, 2.5]}
  moved = utils.to_device(tree, 'cpu')
  assert moved['x'].dtype == torch.float32 and moved['x'].shape == (2, 3)
  assert moved['m']['ids'].dtype == torch.int64
  assert torch.equal(moved['m']['ids'], torch.arange(3))
  assert torch.equal(moved['t'], torch.ones(2))
  assert torch.equal(moved['list'], torch.tensor([1.5, 2.5]))
  with utils.print_time('block'):
    pass
  assert '[block] time elapsed:' in capsys.readouterr().out
