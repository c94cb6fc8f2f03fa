"""The port's eval slice against the JAX package's, on the CPU.

MS-SSIM, LPIPS and the colormaps against nerfies_tpu's; `render_camera`
(rays made from the camera on the device) against JAX's, with one JAX
param tree carried across by interop; and the eval CLI,
`python -m nerfies_tpu_torch.eval`, on a small synthetic scene after a
2-step run of the port's trainer, its helpers held against those of the
JAX eval.py. The JAX CLI defines absl flags when it is imported; no other
absl CLI is imported in this process.
"""

import importlib
import os
import pathlib
import shutil
import subprocess
import sys
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch
import test_torch_fast_render as tfr

from nerfies_tpu import camera as jax_camera
from nerfies_tpu import configs as jax_configs
from nerfies_tpu import datasets as jax_datasets
from nerfies_tpu import evaluation as jax_evaluation
from nerfies_tpu import fast_render as jax_fast_render
from nerfies_tpu import lpips as jax_lpips
from nerfies_tpu import minigin as jax_gin
from nerfies_tpu import training as jax_training
from nerfies_tpu import utils as jax_utils
from nerfies_tpu import visualization as jax_viz
from nerfies_tpu.ops import ssim as jax_ssim
from nerfies_tpu.parallel import mesh as mesh_lib
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import eval as eval_cli
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import lpips
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import render_video
from nerfies_tpu_torch import train
from nerfies_tpu_torch import utils
from nerfies_tpu_torch import visualization
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.ops import ssim
from tests import torch_parity
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

jax_eval = importlib.import_module('eval')

REPO = pathlib.Path(__file__).resolve().parents[1]
SSIM_ATOL = 1e-5
LPIPS_RTOL = 1e-4
COLOR_ATOL = 1e-6


def _pair(shape, seed=0, noise=0.1):
  rng = np.random.RandomState(seed)
  img0 = scipy.ndimage.gaussian_filter(rng.uniform(size=shape),
                                       (2, 2, 0)).astype(np.float32)
  img1 = np.clip(img0 + noise * rng.randn(*shape), 0, 1).astype(np.float32)
  return img0, img1


# ------------------------------------------------------------------ SSIM

def test_ssim_and_cs_match_jax():
  img0, img1 = _pair((64, 72, 3))
  want = jax_ssim.ssim(jnp.asarray(img0), jnp.asarray(img1), return_cs=True)
  got = ssim.ssim(img0, img1, return_cs=True)
  for g, w in zip(got, want):
    np.testing.assert_allclose(float(g), float(w), atol=SSIM_ATOL)


def _renormalized(num_scales):
  truncated = ssim.MSSSIM_WEIGHTS[:num_scales]
  return tuple(w / sum(truncated) for w in truncated)


@pytest.mark.parametrize('shape,num_scales', [((176, 190, 3), 5),
                                              ((64, 50, 3), 3),
                                              ((33, 40, 3), 2)])
def test_multiscale_ssim_matches_jax(shape, num_scales):
  img0, img1 = _pair(shape, seed=1)
  assert ssim.max_feasible_scales(*shape[:2]) == num_scales
  weights = _renormalized(num_scales)
  want = float(jax_ssim.multiscale_ssim(jnp.asarray(img0), jnp.asarray(img1),
                                        weights=weights))
  got = float(ssim.multiscale_ssim(img0, img1, weights=weights))
  np.testing.assert_allclose(got, want, atol=SSIM_ATOL)
  assert 0.0 < got < 1.0


@pytest.mark.parametrize('size', [(10, 10), (11, 11), (21, 40), (22, 22),
                                  (175, 300), (176, 176), (272, 480),
                                  (1000, 1000)])
def test_max_feasible_scales_matches_jax(size):
  assert ssim.max_feasible_scales(*size) == jax_ssim.max_feasible_scales(
      *size)


def test_avg_pool_pads_odd_sides_as_jax():
  img = np.random.RandomState(2).uniform(size=(7, 9, 3)).astype(np.float32)
  want = np.asarray(jax_ssim._avg_pool2(jnp.asarray(img)))
  got = ssim._avg_pool2(torch.from_numpy(img).double()).numpy()
  assert got.shape == want.shape == (4, 5, 3)
  np.testing.assert_allclose(got, want, atol=1e-6)


def _smooth_pair():
  """The smooth, low-variance pair of tests/test_evaluation.py:198."""
  yy, xx = np.mgrid[0:192, 0:192].astype(np.float32) / 192.0
  img0 = np.stack([0.6 + 0.01 * xx, 0.6 + 0.01 * yy,
                   np.full_like(xx, 0.6)], axis=-1)
  img1 = np.clip(img0 + 1e-3 * np.random.RandomState(4).randn(192, 192, 3),
                 0, 1).astype(np.float32)
  return img0, img1


def test_smooth_low_variance_pair_stays_bounded():
  img0, img1 = _smooth_pair()
  im0, im1 = torch.from_numpy(img0).double(), torch.from_numpy(img1).double()
  for _ in range(3):
    val, cs = ssim.ssim(im0, im1, return_cs=True)
    assert -1.0 <= float(val) <= 1.0 + 1e-6, float(val)
    assert -1.0 <= float(cs) <= 1.0 + 1e-6, float(cs)
    im0, im1 = ssim._avg_pool2(im0), ssim._avg_pool2(im1)
  got = float(ssim.multiscale_ssim(img0, img1))
  assert 0.0 <= got <= 1.0 + 1e-6, got
  want = float(jax_ssim.multiscale_ssim(jnp.asarray(img0), jnp.asarray(img1)))
  np.testing.assert_allclose(got, want, atol=SSIM_ATOL)


# ----------------------------------------------------------------- LPIPS

@pytest.mark.parametrize('seed', [0, 3])
def test_lpips_fallback_params_equal_jax(seed):
  want = jax_lpips.init_random_params(seed)
  got = lpips.init_random_params(seed)
  assert set(got) == set(want)
  for key in want:
    assert np.array_equal(got[key], want[key]), key
    assert got[key].dtype == want[key].dtype, key
  model = lpips.LPIPS(seed=seed, device='cpu')
  assert not model.calibrated
  assert all(np.array_equal(model.params[k], want[k]) for k in want)


@pytest.mark.parametrize('shape', [(48, 64, 3), (31, 40, 3)])
def test_lpips_distance_matches_jax(shape):
  img0, img1 = _pair(shape, seed=5, noise=0.05)
  want = jax_lpips.LPIPS()(img0, img1)
  got = lpips.LPIPS(device='cpu')(img0, img1)
  np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)
  # The batched form, per image.
  batch = np.stack([img0, img1])
  params = lpips._to_tensors(jax_lpips.init_random_params(0), 'cpu')
  got_b = lpips.lpips_distance(params, torch.from_numpy(batch).double(),
                               torch.from_numpy(batch[::-1].copy()).double())
  want_b = jax_lpips.lpips_distance(jax_lpips.init_random_params(0),
                                    jnp.asarray(batch),
                                    jnp.asarray(batch[::-1]))
  np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                             rtol=LPIPS_RTOL)


def test_lpips_of_an_image_too_small_is_nan_as_in_jax():
  img0, img1 = _pair((16, 24, 3), seed=6)
  assert np.isnan(jax_lpips.LPIPS()(img0, img1))
  assert np.isnan(lpips.LPIPS(device='cpu')(img0, img1))


def _weights_file(path, drop=None):
  params = jax_lpips.init_random_params(7)
  params.pop('calibrated')
  rng = np.random.RandomState(8)
  params = {k: (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in params.items() if k != drop}
  np.savez(path, **params)
  return path


def test_lpips_weights_file_round_trip(tmp_path):
  path = _weights_file(tmp_path / 'lpips_alex.npz')
  want_params = jax_lpips.load_params(path)
  got_params = lpips.load_params(path)
  assert set(got_params) == set(want_params)
  for key in want_params:
    assert np.array_equal(got_params[key], want_params[key]), key
  want = jax_lpips.LPIPS(weights_path=path)
  got = lpips.LPIPS(weights_path=path, device='cpu')
  assert got.calibrated and want.calibrated
  img0, img1 = _pair((40, 48, 3), seed=9)
  np.testing.assert_allclose(got(img0, img1), want(img0, img1),
                             rtol=LPIPS_RTOL)


def test_lpips_weights_file_missing_a_key_raises(tmp_path):
  path = _weights_file(tmp_path / 'partial.npz', drop='lin4_w')
  for module in (jax_lpips, lpips):
    with pytest.raises(ValueError, match="missing 'lin4_w'"):
      module.load_params(path)


# -------------------------------------------------------------- colormaps

_DEPTH = np.random.RandomState(10).uniform(1.0, 3.0, (24, 32))
_COLORIZE_CASES = {
    'turbo': (_DEPTH, dict(cmap='turbo')),
    'magma': (_DEPTH, dict()),
    'inverted': (_DEPTH, dict(cmin=1.5, cmax=2.5, cmap='turbo', invert=True)),
    'constant': (np.ones((8, 8)), dict(cmin=0.0, cmax=1.0)),
    'constant_no_range': (np.full((8, 8), 0.3), dict()),
}


@pytest.mark.parametrize('case', sorted(_COLORIZE_CASES))
def test_colorize_matches_jax(case):
  array, kwargs = _COLORIZE_CASES[case]
  want = jax_viz.colorize(array, **kwargs)
  got = visualization.colorize(array, **kwargs)
  assert got.shape == array.shape + (3,)
  np.testing.assert_allclose(got, want, atol=COLOR_ATOL)


@pytest.mark.parametrize('classes', [4, 12])
def test_colorize_binary_logits_matches_jax(classes):
  logits = np.random.RandomState(11).randn(16, 16, classes)
  np.testing.assert_allclose(visualization.colorize_binary_logits(logits),
                             jax_viz.colorize_binary_logits(logits),
                             atol=COLOR_ATOL)


@pytest.mark.parametrize('name', ['turbo', 'magma', 'viridis'])
@pytest.mark.parametrize('num_bins', [2, 7, 256, 1000])
def test_colormap_tables_match_matplotlib(name, num_bins):
  np.testing.assert_array_equal(visualization.get_colormap(name, num_bins),
                                jax_viz.get_colormap(name, num_bins))


# ---------------------------------------------------------- render_camera

_METADATA = {'warp': 1, 'appearance': 0, 'camera': 0, 'time': 0.3}


def _distorted_camera(size=(9, 7)):
  cam = synthetic.make_orbit_camera(0.7, image_size=size)
  cam.radial_distortion = np.array([0.05, -0.02, 0.01], np.float32)
  cam.tangential_distortion = np.array([0.01, -0.005], np.float32)
  return cam


@pytest.fixture(scope='module')
def model_pair():
  return tfr._build('se3')


def test_render_camera_matches_jax(model_pair):
  jax_model, jax_params, model, params = model_pair
  cam = _distorted_camera()
  want = jax_evaluation.render_camera(
      jax_training.create_train_state(jax_params, warp_alpha=1.5),
      jax_camera.Camera(**cam.get_parameters()), _METADATA,
      jax_evaluation.make_render_fn(jax_model, mesh_lib.create_mesh()),
      chunk=16)
  got = evaluation.render_camera(
      evaluation.RenderState(params, warp_alpha=1.5), cam, _METADATA,
      evaluation.make_render_fn(model, device='cpu'), chunk=16)
  for key in ('rgb', 'depth', 'med_depth', 'acc'):
    assert got[key].shape == want[key].shape, key
    assert got[key].shape[:2] == (7, 9)
    np.testing.assert_allclose(got[key], want[key], atol=tfr.ATOL,
                               rtol=tfr.RTOL, err_msg=key)
  assert got['rays_per_sec'] > 0 and got['render_time'] > 0


def test_render_camera_matches_render_image_of_host_rays(model_pair):
  _, _, model, params = model_pair
  cam = _distorted_camera()
  state = evaluation.RenderState(params, warp_alpha=1.5)
  fn = evaluation.make_render_fn(model, device='cpu')
  rays = datasets.camera_to_rays(cam)
  rays['metadata'] = {k: np.full((7, 9, 1), v, np.float32 if k == 'time'
                                 else np.uint32)
                      for k, v in _METADATA.items()}
  want = evaluation.render_image(state, rays, fn, chunk=16)
  got = evaluation.render_camera(state, cam, _METADATA, fn, chunk=16)
  # The rays differ in their last bits (numpy on the host, torch here),
  # which moves the fine level's resampled depths: the render tolerance.
  for key in ('rgb', 'depth', 'med_depth', 'acc'):
    np.testing.assert_allclose(got[key], want[key], atol=tfr.ATOL,
                               rtol=tfr.RTOL, err_msg=key)


def test_render_camera_chunk_invariance(model_pair):
  _, _, model, params = model_pair
  cam = _distorted_camera((11, 5))
  state = evaluation.RenderState(params, warp_alpha=1.5)
  fn = evaluation.make_render_fn(model, device='cpu')
  whole = evaluation.render_camera(state, cam, _METADATA, fn, chunk=4096)
  odd = evaluation.render_camera(state, cam, _METADATA, fn, chunk=7)
  for key in ('rgb', 'depth', 'med_depth', 'acc'):
    assert odd[key].shape[:2] == (5, 11)
    np.testing.assert_allclose(odd[key], whole[key], atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------- eval CLI

GIN = str(REPO / 'configs' / 'test_local.gin')
BINDINGS = [
    'ModelConfig.use_fused_mlp = True',
    'ModelConfig.num_coarse_samples = 4',
    'ModelConfig.num_fine_samples = 4',
    'ModelConfig.nerf_trunk_depth = 2',
    'ModelConfig.nerf_trunk_width = 32',
    'ModelConfig.nerf_rgb_branch_width = 16',
    'ModelConfig.nerf_skips = ()',
    'ModelConfig.num_nerf_point_freqs = 3',
    'ModelConfig.num_nerf_viewdir_freqs = 2',
    'ModelConfig.num_warp_freqs = 2',
    "ModelConfig.warp_kwargs = {'trunk_depth': 2, 'skips': ()}",
    'ExperimentConfig.image_scale = 1',
    'TrainConfig.batch_size = 32',
    'TrainConfig.max_steps = 2',
    'TrainConfig.save_every = 2',
]
EVAL_BINDINGS = [
    'EvalConfig.eval_once = True',
    'EvalConfig.num_test_eval = 2',
    'EvalConfig.chunk = 300',
    'EvalConfig.max_render_checkpoints = 1',
]
IMAGE = (40, 32)  # (width, height): big enough for LPIPS's five taps


@pytest.fixture(autouse=True)
def _clear_gin():
  yield
  gin.clear_config()
  jax_gin.clear_config()


def _argv(exp, scene, bindings=(), extra=()):
  argv = ['--device', 'cpu', '--base_folder', str(exp), '--data_dir',
          str(scene), '--gin_configs', GIN, *extra]
  for binding in BINDINGS + list(bindings):
    argv += ['--gin_bindings', binding]
  return argv


@pytest.fixture(scope='module')
def experiment(tmp_path_factory):
  """A scene, 2 steps of the port's trainer, then eval_once twice: plain,
  and with --fast_preview into a copy of the experiment."""
  root = tmp_path_factory.mktemp('eval')
  scene, exp, fast = root / 'scene', root / 'exp', root / 'fast'
  synthetic.write_synthetic_dataset(scene, num_train=4, num_val=1,
                                    image_size=IMAGE, num_points=64,
                                    motion_amplitude=0.05)
  no_writer = lambda _: None
  with mock.patch.object(train, '_make_summary_writer', no_writer), \
      mock.patch.object(eval_cli, '_make_summary_writer', no_writer):
    train.main(_argv(exp, scene))
    shutil.copytree(exp, fast)
    # A stale render directory, rotated away by max_render_checkpoints.
    (exp / 'renders' / '1').mkdir(parents=True)
    plain = eval_cli.main(_argv(exp, scene, EVAL_BINDINGS))
    culled = eval_cli.main(_argv(fast, scene, EVAL_BINDINGS,
                                 ['--fast_preview']))
  return dict(scene=scene, exp=exp, fast=fast, plain=plain, culled=culled)


@pytest.mark.parametrize('run', ['plain', 'culled'])
def test_eval_once_reports_the_metrics(experiment, run):
  result = experiment[run]
  assert list(result.metrics) == [2]
  metrics = result.metrics[2]
  assert set(metrics) == {'val', 'train', 'test'}
  for tag in ('val', 'train'):
    for key in ('psnr', 'ms_ssim', 'lpips_uncal', 'mse', 'render_time'):
      assert np.isfinite(metrics[tag][key]), (tag, key)
    assert 0.0 < metrics[tag]['ms_ssim'] <= 1.0
  assert set(metrics['test']) == {'render_time', 'rays_per_sec'}
  # 1 val, 4 train (strided to 10 asks for all) and 2 test cameras.
  assert [(t, i) for _, t, i, _ in result.frames] == [
      ('val', '0004'), ('train', '0000'), ('train', '0001'),
      ('train', '0002'), ('train', '0003'), ('test', '0000'),
      ('test', '0001')]


def test_eval_writes_and_rotates_renders(experiment):
  renders = experiment['exp'] / 'renders'
  assert sorted(p.name for p in renders.iterdir()) == ['2']
  for tag, item in (('val', '0004'), ('train', '0003'), ('test', '0001')):
    item_dir = renders / '2' / tag / item
    assert sorted(p.name for p in item_dir.iterdir()) == [
        'acc.png', 'depth_median.png', 'depth_median_raw.png', 'rgb.png']
    assert image_utils.load_image(item_dir / 'rgb.png').shape == (32, 40, 3)
    assert image_utils.load_image(
        item_dir / 'depth_median_raw.png').dtype == np.uint16


def test_fast_preview_bakes_a_grid_per_checkpoint(experiment):
  bakes = experiment['culled'].bakes
  assert len(bakes) == 1 and bakes[0]['step'] == 2
  assert bakes[0]['resolution'] == 128
  assert 0.0 <= bakes[0]['occupied'] <= 1.0 and bakes[0]['seconds'] > 0
  assert not experiment['plain'].bakes


def test_fast_preview_preset_overrides_an_explicit_culling_off():
  """As eval.py:281-300, the preset turns culling on whatever the binding
  says (ROADMAP Queue 3 records this JAX behaviour); explicit sample
  counts and keeps win."""
  _, _, _, eval_config = eval_cli.parse_configs(
      [GIN], BINDINGS + ['EvalConfig.use_occupancy_culling = False',
                         'EvalConfig.occupancy_keep_fine = 20'],
      fast_preview=True)
  assert eval_config.use_occupancy_culling
  assert (eval_config.num_coarse_samples, eval_config.num_fine_samples) == (
      32, 64)
  assert (eval_config.occupancy_keep_coarse,
          eval_config.occupancy_keep_fine) == (16, 20)
  _, _, _, plain = eval_cli.parse_configs([GIN], BINDINGS)
  assert not plain.use_occupancy_culling and not plain.fast_preview


def _jax_datasource(scene, config):
  return jax_datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)}, image_scale=1,
      use_appearance_id=config.use_appearance_metadata,
      use_camera_id=config.use_camera_metadata,
      use_warp_id=config.use_warp,
      use_time=config.warp_metadata_encoder_type == 'time', random_seed=0)


@pytest.mark.parametrize('encoder', ['glo', 'time'])
def test_test_camera_ids_match_jax(experiment, encoder):
  switches = dict(use_warp=True, use_appearance_metadata=True,
                  use_camera_metadata=True,
                  warp_metadata_encoder_type=encoder)
  jax_config = jax_configs.ModelConfig(**switches)
  config = configs.ModelConfig(**switches)
  want_source = _jax_datasource(experiment['scene'], jax_config)
  source = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(experiment['scene'])},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True, use_time=encoder == 'time', random_seed=0)
  want = list(jax_eval._test_cameras_iterator(
      want_source, want_source.load_test_cameras(count=4), jax_config,
      seed=7))
  got = list(eval_cli._test_cameras_iterator(
      source, source.load_test_cameras(count=4), config, seed=7))
  assert len(got) == len(want) == 6
  assert [b['metadata'] for b in got] == [b['metadata'] for b in want]
  assert ('time' in got[0]['metadata']) == (encoder == 'time')
  for g, w in zip(got, want):
    for key, value in w['camera_params'].items():
      np.testing.assert_array_equal(g['camera_params'][key], value)


@pytest.mark.parametrize('shape', [(200, 180, 3), (48, 40, 3), (8, 9, 3)])
def test_compute_multiscale_ssim_matches_jax(shape):
  img0, img1 = _pair(shape, seed=12) if min(shape[:2]) > 10 else (
      np.zeros(shape, np.float32), np.ones(shape, np.float32))
  want = jax_eval.compute_multiscale_ssim(img0, img1)
  got = eval_cli.compute_multiscale_ssim(img0, img1)
  if np.isnan(want):
    assert np.isnan(got)
  else:
    np.testing.assert_allclose(got, want, atol=SSIM_ATOL)


@pytest.mark.parametrize('max_renders', [0, 2, 5])
def test_delete_old_renders_matches_jax(tmp_path, max_renders):
  kept = {}
  for name, fn in (('jax', jax_eval.delete_old_renders),
                   ('port', eval_cli.delete_old_renders)):
    root = tmp_path / name
    for step in (1, 2, 10, 3):
      (root / str(step)).mkdir(parents=True)
    (root / '10' / 'rgb.png').write_bytes(b'')
    fn(root, max_renders)
    kept[name] = sorted(p.name for p in root.iterdir())
  assert kept['port'] == kept['jax']


@pytest.mark.parametrize('count', [None, 0, 1, 3, 10])
def test_strided_subset_matches_jax(count):
  ids = [f'{i:04d}' for i in range(7)]
  assert utils.strided_subset(ids, count) == jax_utils.strided_subset(
      ids, count)


_UNSUPPORTED = {
    'trunk_condition': ['ModelConfig.use_trunk_condition = True'],
    'time_encoder': ["ModelConfig.warp_metadata_encoder_type = 'time'"],
    'pivot': ["ModelConfig.warp_kwargs = {'use_pivot': True}"],
}


_SE3 = torch_parity.SMALL_MODEL['warp_kwargs']
_RENDER_MODELS = {
    'trunk_condition': dict(use_appearance_metadata=True,
                            use_trunk_condition=True),
    'time_encoder': dict(warp_metadata_encoder_type='time'),
    'pivot': dict(warp_kwargs={**_SE3, 'use_pivot': True}),
    'supported': dict(),
}


@pytest.mark.parametrize('case', sorted(_UNSUPPORTED) + ['supported'])
def test_eval_renders_what_jax_renders_through_model_apply(case, tmp_path):
  """The CLIs take every architecture on to its data, and the render
  function picks JAX's route: the serving kernels where
  fast_render.supported holds, NerfModel.forward (model.apply) otherwise;
  render_camera then agrees with JAX's."""
  bindings = _UNSUPPORTED.get(case, [])
  jax_gin.add_search_path(str(REPO / 'configs'))
  jax_gin.parse_config_files_and_bindings(config_files=[GIN],
                                          bindings=BINDINGS + bindings)
  jax_config = jax_configs.ModelConfig(use_stratified_sampling=False)
  jax_supported = jax_fast_render.supported(
      types.SimpleNamespace(**vars(jax_config), metadata_encoded=False))
  assert jax_supported == (case == 'supported')
  missing = tmp_path / 'no_such_scene'
  argv = _argv(tmp_path / 'exp', missing, bindings + EVAL_BINDINGS)
  for cli in (eval_cli, render_video):
    with pytest.raises(FileNotFoundError):  # it goes on to read the data
      cli.main(argv)

  jax_model, jax_params, model, params = torch_parity.model_pair(
      use_warp_jacobian=False, use_weights=False, **_RENDER_MODELS[case])
  fn = evaluation.make_render_fn(model, device='cpu')
  assert fn.fast == jax_supported
  cam = _distorted_camera()
  want = jax_evaluation.render_camera(
      jax_training.create_train_state(jax_params, warp_alpha=1.5,
                                      time_alpha=0.4),
      jax_camera.Camera(**cam.get_parameters()), _METADATA,
      jax_evaluation.make_render_fn(jax_model, mesh_lib.create_mesh()),
      chunk=16)
  got = evaluation.render_camera(
      evaluation.RenderState(params, warp_alpha=1.5, time_alpha=0.4), cam,
      _METADATA, fn, chunk=16)
  for key in ('rgb', 'depth', 'acc'):
    np.testing.assert_allclose(got[key], want[key], atol=tfr.ATOL,
                               rtol=tfr.RTOL, err_msg=key)


def test_fast_off_renders_through_the_forward():
  """fast='off' sends a model the serving path covers through
  NerfModel.forward (float32), which agrees with the serving kernels
  (bf16) at the render tolerance; a stratified model renders through it
  too, each chunk drawing from fold_in(seed, chunk)."""
  _, _, model, params = torch_parity.model_pair(
      use_warp_jacobian=False, use_weights=False, use_camera_metadata=True)
  cam = _distorted_camera()
  state = evaluation.RenderState(params, warp_alpha=1.5)
  auto = evaluation.make_render_fn(model, device='cpu')
  off = evaluation.make_render_fn(model, device='cpu', fast='off')
  assert auto.fast and not off.fast
  want = evaluation.render_camera(state, cam, _METADATA, auto, chunk=16)
  with mock.patch.object(evaluation.fast_render, 'render_rays',
                         side_effect=AssertionError('serving path')):
    got = evaluation.render_camera(state, cam, _METADATA, off, chunk=16)
  for key in ('rgb', 'depth', 'acc'):
    np.testing.assert_allclose(got[key], want[key], atol=tfr.ATOL,
                               rtol=tfr.RTOL, err_msg=key)
  model.use_stratified_sampling = True
  stratified = evaluation.make_render_fn(model, device='cpu')
  assert not stratified.fast and stratified.stratified
  renders = [evaluation.render_camera(state, cam, _METADATA, stratified,
                                      chunk=16, seed=seed)
             for seed in (3, 3, 4)]
  np.testing.assert_array_equal(renders[1]['rgb'], renders[0]['rgb'])
  assert not np.array_equal(renders[2]['rgb'], renders[0]['rgb'])
  assert np.isfinite(renders[0]['rgb']).all()
  with pytest.raises(ValueError, match='fast'):
    evaluation.make_render_fn(model, device='cpu', fast='on')


def test_eval_cli_runs_as_a_module(experiment, tmp_path):
  """`python -m nerfies_tpu_torch.eval` in a subprocess, with TensorBoard
  where it is installed (TensorFlow kept out, as in the train CLI test)."""
  exp = tmp_path / 'exp'
  shutil.copytree(experiment['exp'] / 'checkpoints', exp / 'checkpoints')
  argv = _argv(exp, experiment['scene'], EVAL_BINDINGS)
  code = ('import runpy, sys; sys.modules["tensorflow"] = None; '
          f'sys.argv = ["eval"] + {argv!r}; '
          'runpy.run_module("nerfies_tpu_torch.eval", run_name="__main__", '
          'alter_sys=True)')
  proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                        env=dict(os.environ, PYTHONPATH=str(REPO)),
                        capture_output=True, text=True, timeout=300,
                        check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert 'Evaluating checkpoint at step 2' in proc.stderr
  assert '[val/0004] ' in proc.stderr and 'lpips_uncal=' in proc.stderr
  assert (exp / 'renders' / '2' / 'test' / '0001' / 'rgb.png').is_file()
  assert any((exp / 'summaries' / 'eval').iterdir())


def test_render_video_writes_png_frames(experiment, tmp_path):
  out = tmp_path / 'video'
  paths = render_video.main(
      _argv(experiment['exp'], experiment['scene'],
            extra=['--camera_path', 'orbit-mild', '--chunk', '500',
                   '--output_dir', str(out)]))
  assert [p.name for p in paths] == [f'{i:06d}.png' for i in range(6)]
  for path in paths:
    assert image_utils.load_image(path).shape == (32, 40, 3)


def test_eval_clis_need_a_card_unless_told_cpu(experiment):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is valid')
  argv = _argv(experiment['exp'], experiment['scene'])[2:]
  with pytest.raises(RuntimeError, match='device="cpu"'):
    eval_cli.main(argv)
  with pytest.raises(RuntimeError, match='device="cpu"'):
    render_video.main(argv)
