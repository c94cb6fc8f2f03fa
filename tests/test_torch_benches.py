"""The port's quality and serving benches, at a tiny width on the CPU.

`quality_bench.run` takes the model config, so the tests narrow the bench
model without a flag: 2-3 steps on a 24x16 scene. The curve has the JAX
script's keys; the saved npz has the names of JAX's flattened tree for
the same config; an npz written in JAX's layout loads through the serve
bench's loader; a resumed run ends bit for bit where an unbroken one
does, its curve rows equal apart from the wall clock; the serve bench
renders its four modes.
"""

import dataclasses
import json
import shutil

from flax import traverse_util
import jax
import numpy as np
import pytest
import torch

from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import serve_bench
from nerfies_tpu_torch.ops import fused_mlp
from tests.torch_parity import jax_config
from tests.torch_parity import jax_model_and_shapes
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import random_params

CURVE_KEYS = {'step', 'val_psnr', 'train_view_psnr', 'val_ms_ssim',
              'train_loss', 'render_delta', 'warp_alpha', 'wall_s'}
RESULT_KEYS = {'workload', 'image_size', 'batch_size', 'steps', 'device',
               'curve'}
TINY = dict(nerf_trunk_depth=2, nerf_trunk_width=32, nerf_rgb_branch_width=16,
            nerf_skips=(1,), num_coarse_samples=4, num_fine_samples=4,
            num_nerf_point_freqs=2, num_nerf_viewdir_freqs=1,
            num_warp_freqs=2, num_warp_features=4,
            warp_kwargs={'trunk_depth': 2, 'trunk_width': 16, 'skips': (1,)})


def _config():
  return dataclasses.replace(quality_bench.model_config(), **TINY)


def _args(tmp_path, *extra):
  return quality_bench.parse_args([
      '--steps', '2', '--eval_every', '1', '--batch_size', '64',
      '--image_size', '24', '16', '--num_train', '4', '--device', 'cpu',
      '--scene_dir', str(tmp_path / 'scene'), '--work_dir',
      str(tmp_path / 'work'), '--out', str(tmp_path / 'curve.json'),
      '--save_params', str(tmp_path / 'params.npz'), *extra])


@pytest.fixture(scope='module')
def quality_run(tmp_path_factory):
  tmp_path = tmp_path_factory.mktemp('quality')
  return tmp_path, quality_bench.run(_args(tmp_path), _config())


def _flat_jax_tree(source):
  """The '/'-flattened names of JAX's construct_nerf tree for the tiny
  config and the scene's ids."""
  fields = {f.name: getattr(_config(), f.name)
            for f in dataclasses.fields(_config())}
  _, shapes = jax_model_and_shapes(
      jax_config(**fields), appearance_ids=source.appearance_ids,
      camera_ids=source.camera_ids, warp_ids=source.warp_ids,
      near=source.near, far=source.far, use_warp_jacobian=True,
      use_weights=True)
  return shapes


def test_curve_has_the_jax_keys(quality_run):
  tmp_path, run = quality_run
  written = json.loads((tmp_path / 'curve.json').read_text())
  assert written == run.result
  assert set(written) == RESULT_KEYS and 'partial' not in written
  assert written['device'] == 'cpu' and written['steps'] == 2
  assert [row['step'] for row in written['curve']] == [1, 2]
  for row in written['curve']:
    assert set(row) == CURVE_KEYS
    for key in CURVE_KEYS - {'render_delta', 'val_ms_ssim'}:
      assert np.isfinite(row[key]), key
  # 24x16 fits one MS-SSIM scale.
  assert 0.0 <= written['curve'][0]['val_ms_ssim'] <= 1.0
  assert written['curve'][0]['render_delta'] is None
  assert written['curve'][1]['render_delta'] > 0
  assert len(run.step_seconds) == 2 and run.state.step == 2


def test_saved_npz_has_the_jax_names(quality_run):
  tmp_path, run = quality_run
  source = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(tmp_path / 'scene')},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True)
  flat = traverse_util.flatten_dict(_flat_jax_tree(source), sep='/')
  with np.load(tmp_path / 'params.npz') as data:
    names = set(data.files)
    assert float(data['__warp_alpha__']) == run.state.warp_alpha
    assert float(data['__time_alpha__']) == 0.0
    for key, shape in flat.items():
      assert data[key].shape == shape.shape, key
  assert names == set(flat) | {'__warp_alpha__', '__time_alpha__'}
  tree, warp_alpha, time_alpha = serve_bench.load_params(
      tmp_path / 'params.npz')
  for path, t in fused_mlp.flatten_tree(run.state.params):
    np.testing.assert_array_equal(
        fused_mlp.tree_leaf(tree, path), t.detach().numpy())
  assert (warp_alpha, time_alpha) == (run.state.warp_alpha, 0.0)


def test_jax_layout_npz_loads_through_the_serve_loader(tmp_path,
                                                       quality_run):
  scene = quality_run[0] / 'scene'
  source = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)}, image_scale=1,
      use_appearance_id=True, use_camera_id=True, use_warp_id=True)
  jparams = random_params(_flat_jax_tree(source), seed=2)
  # quality_bench.py's _save_params, as the JAX script writes it.
  flat = traverse_util.flatten_dict(jax.device_get(jparams), sep='/')
  flat['__warp_alpha__'] = np.asarray(np.float32(1.25))
  flat['__time_alpha__'] = np.asarray(np.float32(0.5))
  np.savez(tmp_path / 'jax.npz', **{k: np.asarray(v) for k, v in flat.items()})
  tree, warp_alpha, time_alpha = serve_bench.load_params(tmp_path / 'jax.npz')
  assert (warp_alpha, time_alpha) == (1.25, 0.5)
  got = dict(fused_mlp.flatten_tree(interop.params_from_jax(tree, 'cpu')))
  want = dict(fused_mlp.flatten_tree(interop.params_from_jax(jparams, 'cpu')))
  assert got.keys() == want.keys()
  for key in want:
    assert torch.equal(got[key], want[key]), key


def test_resumed_run_ends_where_an_unbroken_one_does(tmp_path):
  unbroken = quality_bench.run(_args(tmp_path, '--steps', '3'), _config())
  # Drop the newest checkpoint: the resumed run restarts at step 2.
  shutil.rmtree(tmp_path / 'work' / '3')
  resumed = quality_bench.run(_args(tmp_path, '--steps', '3', '--resume'),
                              _config())
  assert len(resumed.step_seconds) == 1
  want = dict(fused_mlp.flatten_tree(unbroken.state.params))
  for path, t in fused_mlp.flatten_tree(resumed.state.params):
    assert torch.equal(t, want[path]), path
  assert [r['step'] for r in resumed.result['curve']] == [1, 2, 3]
  for got, want in zip(resumed.result['curve'], unbroken.result['curve']):
    got.pop('wall_s'), want.pop('wall_s')
    assert got == want


def test_resume_is_off_by_default():
  args = quality_bench.parse_args([])
  assert not args.resume and args.fused
  for path in (args.out, args.work_dir, args.scene_dir):
    assert 'docs' not in path.split('/')
    assert 'nerfies_tpu_torch' in path


@pytest.mark.parametrize('hd', [False, True])
def test_serve_bench_renders_four_modes(quality_run, monkeypatch, hd):
  tmp_path, _ = quality_run
  monkeypatch.setattr(serve_bench, 'HD_SIZE', (32, 18))
  out = tmp_path / f'serve_{hd}.json'
  args = serve_bench.parse_args([
      '--params', str(tmp_path / 'params.npz'), '--scene_dir',
      str(tmp_path / 'scene'), '--grid_resolution', '16', '--chunk', '128',
      '--hd_chunk', '256', '--out', str(out), '--device', 'cpu',
      '--measure_1080p' if hd else '--no-measure_1080p'])
  run = serve_bench.run(args, _config())
  written = json.loads(out.read_text())
  assert written == run.result
  assert [r['mode'] for r in written['modes']] == [
      m[0] for m in serve_bench.MODES]
  for row in written['modes']:
    assert np.isfinite(row['rays_per_sec']) and np.isfinite(row['psnr'])
    key = 'measured_1080p_s' if hd else 'projected_1080p_s'
    assert np.isfinite(row[key])
  assert 0.0 <= written['grid']['occupied_fraction'] <= 1.0
  assert written['device'] == 'cpu'


def test_benches_refuse_a_missing_card(tmp_path, monkeypatch):
  monkeypatch.setattr('torch.cuda.is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    quality_bench.main(['--scene_dir', str(tmp_path / 'scene'), '--out',
                        str(tmp_path / 'curve.json')])
  with pytest.raises(RuntimeError, match='CUDA'):
    serve_bench.main(['--params', str(tmp_path / 'params.npz'), '--out',
                      str(tmp_path / 'serve.json')])
  assert not list(tmp_path.iterdir())
