"""The port's image IO, camera, data pipeline and checkpoints against JAX's.

PNGs written by the JAX package (cv2) decode bit for bit in the port and
the port's decode bit for bit in cv2; resizes match cv2 within 1 for
uint8 and atol 1e-5 for float32, depth nearest exactly; the numpy camera
at atol 1e-6 and the tensor ray generation at f32, atol 1e-5; on one
scene the two data sources give bit-identical batches (preloaded and
streaming pools, background points, val images); the port's scene writer
writes JAX's scene. Inputs come from numpy seeds.
"""

import json
import math
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
from PIL import Image
import pytest
import torch

from nerfies_tpu import camera as jax_camera
from nerfies_tpu import checkpoints as jax_checkpoints
from nerfies_tpu import datasets as jax_datasets
from nerfies_tpu import image_utils as jax_image_utils
from nerfies_tpu.datasets import core as jax_core
from nerfies_tpu.datasets import synthetic as jax_synthetic
from nerfies_tpu_torch import camera
from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import core
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.ops import fused_mlp


def _image(shape, dtype, seed=0):
  """A smooth image with noise, so encoders pick varied row filters."""
  rng = np.random.RandomState(seed)
  h, w = shape[:2]
  yy, xx = np.mgrid[0:h, 0:w]
  base = np.sin(xx / 7.0) + np.cos(yy / 5.0) + 0.3 * rng.rand(h, w)
  base = (base - base.min()) / (base.max() - base.min())
  if len(shape) == 3:
    base = np.stack([np.roll(base, 3 * k, 1) for k in range(shape[2])], -1)
  if dtype == np.float32:
    return base.astype(np.float32)
  return (base * np.iinfo(dtype).max).astype(dtype)


def _png_filters(data):
  """The row filter types of a PNG's image data."""
  pos, idat, header = 8, [], None
  while pos < len(data):
    length, kind = struct.unpack('>I4s', data[pos:pos + 8])
    if kind == b'IHDR':
      header = struct.unpack('>IIBBBBB', data[pos + 8:pos + 8 + length])
    elif kind == b'IDAT':
      idat.append(data[pos + 8:pos + 8 + length])
    pos += 12 + length
  height = header[1]
  raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
  return set(raw.reshape(height, -1)[:, 0].tolist())


_CV2_MODES = [((17, 23), 'gray'), ((17, 23, 3), 'rgb'),
              ((17, 23, 4), 'rgba')]


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
@pytest.mark.parametrize('shape,mode', _CV2_MODES, ids=lambda v: str(v))
def test_port_decodes_cv2_pngs(tmp_path, shape, mode, dtype):
  image = _image(shape, dtype)
  path = tmp_path / f'{mode}.png'
  jax_image_utils.save_image(path, image)
  got = image_utils.load_image(path)
  want = jax_image_utils.load_image(path)
  assert got.dtype == want.dtype == image.dtype
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
@pytest.mark.parametrize('shape,mode', _CV2_MODES + [((17, 23, 2), 'gray_alpha')],
                         ids=lambda v: str(v))
def test_cv2_decodes_port_pngs(tmp_path, shape, mode, dtype):
  image = _image(shape, dtype, seed=1)
  path = tmp_path / f'{mode}.png'
  image_utils.save_image(path, image)
  got = jax_image_utils.load_image(path)
  assert got.dtype == image.dtype
  np.testing.assert_array_equal(got, image_utils.load_image(path))
  if mode == 'gray_alpha':  # cv2 gives RGBA, the gray value repeated
    image = image[..., [0, 0, 0, 1]]
  np.testing.assert_array_equal(got, image)


def test_port_pngs_use_every_filter_and_decode():
  """The decoder on every filter (libpng through cv2, all filters
  allowed) and on the port's own PNGs (Sub filters, as cv2 writes)."""
  image = _image((64, 80, 3), np.uint8, seed=2)
  ok, data = cv2.imencode('.png', image[..., ::-1],
                          [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
  assert ok
  assert _png_filters(data.tobytes()) >= {1, 2, 3, 4}
  np.testing.assert_array_equal(image_utils.decode_png(data.tobytes()), image)
  own = image_utils.encode_png(image)
  assert _png_filters(own) == {1}
  np.testing.assert_array_equal(image_utils.decode_png(own), image)


def test_pillow_pngs_decode(tmp_path):
  """Another encoder (libpng through Pillow, adaptive filters)."""
  for mode, shape in (('L', (19, 21)), ('LA', (19, 21, 2)),
                      ('RGB', (19, 21, 3)), ('RGBA', (19, 21, 4))):
    image = _image(shape, np.uint8, seed=3)
    path = tmp_path / f'{mode}.png'
    Image.fromarray(image, mode).save(path)
    np.testing.assert_array_equal(image_utils.load_image(path),
                                  jax_image_utils.load_image(path))


def _with_ihdr(data, **fields):
  names = ('width', 'height', 'depth', 'color', 'compression', 'filter',
           'interlace')
  values = dict(zip(names, struct.unpack('>IIBBBBB', data[16:29])))
  values.update(fields)
  body = struct.pack('>IIBBBBB', *(values[n] for n in names))
  crc = struct.pack('>I', zlib.crc32(b'IHDR' + body) & 0xFFFFFFFF)
  return data[:16] + body + crc + data[33:]


def test_unsupported_pngs_raise(tmp_path):
  data = image_utils.encode_png(_image((8, 8, 3), np.uint8))
  with pytest.raises(ValueError, match='interlaced'):
    image_utils.decode_png(_with_ihdr(data, interlace=1))
  path = tmp_path / 'palette.png'
  Image.fromarray(_image((8, 8), np.uint8)).convert('P').save(path)
  with pytest.raises(ValueError, match='palette'):
    image_utils.load_image(path)
  with pytest.raises(ValueError, match='not a PNG'):
    image_utils.decode_png(b'GIF89a' + data[6:])


_RESIZES = {
    'down2': lambda m, x: m.downsample_image(x, 2),
    'down4': lambda m, x: m.downsample_image(x, 4),
    'up2': lambda m, x: m.upsample_image(x, 2),
    'up3': lambda m, x: m.upsample_image(x, 3),
    'reshape_area': lambda m, x: m.reshape_image(x, (29, 41)),
    'reshape_linear': lambda m, x: m.reshape_image(x, (61, 70)),
    'rescale_0.75': lambda m, x: m.rescale_image(x, 0.75),
    'rescale_0.3': lambda m, x: m.rescale_image(x, 0.3),
    'rescale_1.25': lambda m, x: m.rescale_image(x, 1.25),
    'rescale_0.5': lambda m, x: m.rescale_image(x, 0.5),
}


@pytest.mark.parametrize('name', sorted(_RESIZES))
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_resizes_match_cv2(name, dtype):
  for shape in ((48, 64, 3), (48, 64)):
    image = _image(shape, dtype, seed=4)
    got = _RESIZES[name](image_utils, image)
    want = _RESIZES[name](jax_image_utils, image)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= (1 if dtype == np.uint8 else 1e-5), (name, shape, err)


@pytest.mark.parametrize('scale', [0.5, 0.25, 0.3, 0.77, 2.0, 1.7])
def test_depth_nearest_matches_cv2(scale):
  depth = np.random.RandomState(5).rand(47, 63).astype(np.float32)
  np.testing.assert_array_equal(
      image_utils.rescale_depth_image(depth, scale),
      jax_image_utils.rescale_depth_image(depth, scale))


def test_variance_of_laplacian_matches_cv2():
  for shape in ((30, 40, 3), (30, 40)):
    image = _image(shape, np.float32, seed=6)
    assert math.isclose(image_utils.variance_of_laplacian(image),
                        jax_image_utils.variance_of_laplacian(image),
                        rel_tol=1e-12)


def test_depth_io_matches_jax(tmp_path):
  depth = (2000.0 * np.random.RandomState(7).rand(9, 11)).astype(np.float32)
  jax_image_utils.save_depth(tmp_path / 'a.png', depth)
  image_utils.save_depth(tmp_path / 'b.png', depth)
  for path in (tmp_path / 'a.png', tmp_path / 'b.png'):
    np.testing.assert_array_equal(image_utils.load_depth(path),
                                  jax_image_utils.load_depth(path))


# ------------------------------------------------------------------- camera

def _cameras(rng):
  kwargs = dict(
      orientation=jax_camera.Camera(np.eye(3), np.zeros(3), 1.0,
                                    np.zeros(2), (1, 1)).orientation,
      position=rng.normal(size=3), focal_length=210.0 + rng.rand(),
      principal_point=np.array([40.3, 31.7]), image_size=(80, 60),
      skew=0.01, pixel_aspect_ratio=1.02,
      radial_distortion=np.array([0.05, -0.02, 0.003]),
      tangential_distortion=np.array([0.001, -0.002]))
  return jax_camera.Camera(**kwargs), camera.Camera(**kwargs)


def test_numpy_camera_matches_jax(tmp_path):
  rng = np.random.RandomState(8)
  want, got = _cameras(rng)
  up = np.array([0.0, 1.0, 0.0])
  want = want.look_at(np.array([2.0, 0.5, 1.0]), np.zeros(3), up)
  got = got.look_at(np.array([2.0, 0.5, 1.0]), np.zeros(3), up)
  pixels = (rng.rand(37, 2) * [80, 60]).astype(np.float32)
  points = rng.normal(size=(23, 3)).astype(np.float32)
  close = lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
  close(got.pixels_to_rays(pixels), want.pixels_to_rays(pixels))
  close(got.project(points), want.project(points))
  close(got.get_pixel_centers(), want.get_pixel_centers())
  for a, b in ((got.scale(0.5), want.scale(0.5)),
               (got.crop_image_domain(3, 4, 5, 6),
                want.crop_image_domain(3, 4, 5, 6))):
    for key, value in b.get_parameters().items():
      close(a.get_parameters()[key], value)
  got.save_json(tmp_path / 'cam.json')
  assert json.loads((tmp_path / 'cam.json').read_text()) == want.to_json()
  back = jax_camera.Camera.from_json(tmp_path / 'cam.json')
  close(back.pixels_to_rays(pixels), want.pixels_to_rays(pixels))
  x, y = rng.uniform(-0.3, 0.3, (2, 50))
  for a, b in zip(camera.undistort_np(x, y, 0.05, -0.02, 0.003, 0.001, 0.002),
                  jax_camera.undistort_np(x, y, 0.05, -0.02, 0.003, 0.001,
                                          0.002)):
    close(a, b)


def test_tensor_rays_match_jnp():
  rng = np.random.RandomState(9)
  _, cam = _cameras(rng)
  params = cam.ray_parameters()
  pixels = (rng.rand(5, 7, 2) * [80, 60]).astype(np.float32)
  want = jax_camera.pixels_to_rays(
      jnp.asarray(pixels), **{k: jnp.asarray(v) for k, v in params.items()})
  got = camera.pixels_to_rays(
      torch.from_numpy(pixels),
      **{k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  np.testing.assert_allclose(got.numpy(), cam.pixels_to_rays(pixels),
                             atol=1e-5)
  xd, yd = rng.uniform(-0.3, 0.3, (2, 40)).astype(np.float32)
  radial, tangential = params['radial_distortion'], params[
      'tangential_distortion']
  want = jax_camera.undistort(jnp.asarray(xd), jnp.asarray(yd),
                              jnp.asarray(radial), jnp.asarray(tangential))
  got = camera.undistort(torch.from_numpy(xd), torch.from_numpy(yd),
                         torch.from_numpy(radial),
                         torch.from_numpy(tangential))
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ----------------------------------------------------------------- datasets

_SCENE = dict(num_train=4, num_val=2, image_size=(40, 24),
              image_scales=(1, 2), motion_amplitude=0.1, num_points=96,
              texture_frequency=6.0)


@pytest.fixture(scope='module')
def scene_dir(tmp_path_factory):
  path = tmp_path_factory.mktemp('scene')
  jax_synthetic.write_synthetic_dataset(path, **_SCENE)
  return path


def _sources(scene_dir, **kwargs):
  spec = {'type': 'nerfies', 'data_dir': str(scene_dir)}
  kwargs = dict(image_scale=1, use_appearance_id=True, use_camera_id=True,
                use_warp_id=True, use_time=True, random_seed=3, **kwargs)
  return (datasets.from_config(spec, **kwargs),
          jax_datasets.from_config(spec, **kwargs))


def _assert_trees_equal(got, want):
  assert set(got) == set(want)
  for key, value in want.items():
    if isinstance(value, dict):
      _assert_trees_equal(got[key], value)
    else:
      assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
      np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_sources_agree(scene_dir):
  got, want = _sources(scene_dir)
  for attr in ('train_ids', 'val_ids', 'appearance_ids', 'camera_ids',
               'warp_ids', 'time_ids', 'near', 'far'):
    assert getattr(got, attr) == getattr(want, attr), attr
  for item_id in want.all_ids:
    _assert_trees_equal(got.get_item(item_id, scale_factor=0.5),
                        want.get_item(item_id, scale_factor=0.5))
  assert len(got.load_test_cameras(3)) == len(want.load_test_cameras(3))


@pytest.mark.parametrize('preload', [True, False])
def test_train_batches_are_bit_identical(scene_dir, preload):
  got, want = _sources(scene_dir, preload=preload)
  kw = dict(flatten=True, shuffle=True, batch_size=128, prefetch_size=3)
  got_iter = got.create_iterator(got.train_ids, **kw)
  want_iter = want.create_iterator(want.train_ids, **kw)
  for _ in range(5):
    _assert_trees_equal(next(got_iter), next(want_iter))


def test_point_and_image_iterators_are_bit_identical(scene_dir):
  got, want = _sources(scene_dir)
  points = got.load_points(shuffle=True)
  np.testing.assert_array_equal(points, want.load_points(shuffle=True))
  got_iter = core.iterator_from_arrays(points, batch_size=40, seed=3)
  want_iter = jax_core.iterator_from_arrays(points, batch_size=40, seed=3)
  for _ in range(5):
    np.testing.assert_array_equal(next(got_iter), next(want_iter))
  got_iter = got.create_iterator(got.val_ids, batch_size=0, shuffle=True)
  want_iter = want.create_iterator(want.val_ids, batch_size=0, shuffle=True)
  for _ in range(3):
    _assert_trees_equal(next(got_iter), next(want_iter))


def test_port_writer_writes_the_jax_scene(scene_dir, tmp_path):
  synthetic.write_synthetic_dataset(tmp_path, **_SCENE)
  files = sorted(p.relative_to(scene_dir) for p in scene_dir.rglob('*')
                 if p.is_file())
  assert files == sorted(p.relative_to(tmp_path) for p in tmp_path.rglob('*')
                         if p.is_file())
  for rel in files:
    if rel.suffix == '.png':
      np.testing.assert_array_equal(
          image_utils.load_image(tmp_path / rel),
          jax_image_utils.load_image(scene_dir / rel), err_msg=str(rel))
    else:
      assert (tmp_path / rel).read_bytes() == (scene_dir / rel).read_bytes()


# -------------------------------------------------------------- checkpoints

def _state(seed, step=0):
  gen = torch.Generator().manual_seed(seed)
  params = {'mlp': {'kernel': torch.randn(4, 3, generator=gen),
                    'bias': torch.randn(3, generator=gen)},
            'glo': {'embed': {'embedding': torch.rand(5, 2, generator=gen)}}}
  state = training.create_train_state(params, warp_alpha=1.25,
                                      time_alpha=0.5)
  grads = training._map(lambda p: torch.randn(p.shape, generator=gen), params)
  for _ in range(step):
    new_params, opt = training.adam_update(grads, state.opt_state,
                                           state.params, 1e-3)
    state = training.TrainState(state.step + 1, new_params, opt, 1.25, 0.5)
  return state


def _assert_states_equal(got, want):
  assert (got.step, got.opt_state.count, got.warp_alpha, got.time_alpha) == (
      want.step, want.opt_state.count, want.warp_alpha, want.time_alpha)
  for a, b in ((got.params, want.params),
               (got.opt_state.mu, want.opt_state.mu),
               (got.opt_state.nu, want.opt_state.nu)):
    fa, fb = dict(fused_mlp.flatten_tree(a)), dict(fused_mlp.flatten_tree(b))
    assert fa.keys() == fb.keys()
    for k in fb:
      assert torch.equal(fa[k], fb[k]), k


def test_checkpoint_round_trip_keeps_two(tmp_path):
  for step in (1, 2, 3):
    checkpoints.save_checkpoint(tmp_path, _state(0, step))
  assert sorted(p.name for p in tmp_path.iterdir()) == ['2', '3']
  assert checkpoints.latest_checkpoint_step(tmp_path) == 3
  restored = checkpoints.restore_checkpoint(tmp_path, _state(1))
  _assert_states_equal(restored, _state(0, 3))
  assert all(t.requires_grad
             for _, t in fused_mlp.flatten_tree(restored.params))
  assert not any(t.requires_grad
                 for _, t in fused_mlp.flatten_tree(restored.opt_state.mu))


def test_restore_without_a_checkpoint_returns_the_state(tmp_path):
  state = _state(2)
  assert checkpoints.restore_checkpoint(tmp_path / 'none', state) is state
  assert checkpoints.restore_checkpoint(tmp_path, state) is state


def test_restore_refuses_another_tree(tmp_path):
  checkpoints.save_checkpoint(tmp_path, _state(0, 1))
  other = _state(0)
  other.params['mlp']['kernel'] = torch.zeros(5, 3)
  with pytest.raises(ValueError, match='shape'):
    checkpoints.restore_checkpoint(tmp_path, other)


def test_orbax_checkpoint_raises(tmp_path):
  jax_state = {'step': np.int32(4), 'params': {'w': np.ones((2, 2),
                                                           np.float32)}}
  jax_checkpoints.save_checkpoint(tmp_path, jax_state, step=4)
  assert (tmp_path / '4').is_dir()
  with pytest.raises(ValueError, match='cannot read orbax'):
    checkpoints.restore_checkpoint(tmp_path, _state(0))
