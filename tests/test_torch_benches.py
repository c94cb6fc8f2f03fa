"""The port's quality and serving benches, at a tiny width on the CPU.

`quality_bench.run` takes the model config, so the tests narrow the bench
model without a flag: 2-3 steps on a 24x16 scene. The curve has the JAX
script's keys; the saved npz has the names of JAX's flattened tree for
the same config; an npz written in JAX's layout loads through the serve
bench's loader; a resumed run ends bit for bit where an unbroken one
does, its curve rows equal apart from the wall clock; the serve bench
renders its four modes. Two gloo ranks (tests/torch_bench_workers.py) run
both benches as one process does, and only rank 0 writes.
"""

import dataclasses
import hashlib
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
from tests import torch_bench_workers
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


def _argv(tmp_path, *extra):
  return ['--steps', '2', '--eval_every', '1', '--batch_size', '64',
          '--image_size', '24', '16', '--num_train', '4', '--device', 'cpu',
          '--scene_dir', str(tmp_path / 'scene'), '--work_dir',
          str(tmp_path / 'work'), '--out', str(tmp_path / 'curve.json'),
          '--save_params', str(tmp_path / 'params.npz'), *extra]


def _args(tmp_path, *extra):
  return quality_bench.parse_args(_argv(tmp_path, *extra))


def _serve_argv(tmp_path, hd=True):
  return ['--params', str(tmp_path / 'params.npz'), '--scene_dir',
          str(tmp_path / 'scene'), '--grid_resolution', '16', '--chunk',
          '128', '--hd_chunk', '256', '--out',
          str(tmp_path / f'serve_{hd}.json'), '--device', 'cpu',
          '--measure_1080p' if hd else '--no-measure_1080p']


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


def _init_npz(quality_run, path, drop=()):
  """A random JAX tree of the tiny config and the scene's ids, written as
  scripts/quality_init_jax.py writes JAX's init ('/'-joined names)."""
  source = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(quality_run[0] / 'scene')},
      image_scale=1, use_appearance_id=True, use_camera_id=True,
      use_warp_id=True)
  jparams = random_params(_flat_jax_tree(source), seed=3)
  flat = traverse_util.flatten_dict(jax.device_get(jparams), sep='/')
  np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()
                    if k not in drop})
  return path


def test_init_npz_starts_from_its_params(quality_run, tmp_path,
                                         monkeypatch):
  """--init_npz trains from the npz's params, loaded bit for bit, and the
  curve records the init and the file's sha256."""
  path = _init_npz(quality_run, tmp_path / 'init.npz')
  loaded = []
  load_init = quality_bench.load_init

  def spy(*args):
    params = load_init(*args)
    loaded.append({p: t.clone() for p, t in fused_mlp.flatten_tree(params)})
    return params

  monkeypatch.setattr(quality_bench, 'load_init', spy)
  run = quality_bench.run(
      _args(tmp_path, '--steps', '1', '--scene_dir',
            str(quality_run[0] / 'scene'), '--init_npz', str(path)),
      _config())
  assert run.result['init'] == 'jax'
  assert run.result['init_sha256'] == hashlib.sha256(
      path.read_bytes()).hexdigest()
  assert json.loads((tmp_path / 'curve.json').read_text()) == run.result
  with np.load(path) as data:
    assert len(loaded) == 1 and len(loaded[0]) == len(data.files)
    for name, t in loaded[0].items():
      assert t.dtype == torch.float32
      assert torch.equal(t, torch.from_numpy(data['/'.join(name)])), name
  assert run.state.step == 1


def test_init_npz_of_another_model_raises(quality_run, tmp_path):
  path = _init_npz(quality_run, tmp_path / 'init.npz',
                   drop=('warp_field/trunk/hidden_0/bias',))
  with pytest.raises(ValueError, match='hidden_0/bias'):
    quality_bench.run(
        _args(tmp_path, '--scene_dir', str(quality_run[0] / 'scene'),
              '--init_npz', str(path)), _config())


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


def test_stop_at_ends_the_schedules_of_a_longer_run(tmp_path):
  """--stop_at 2 of --steps 4 gives the first two rows of the 4-step run
  (its schedules, not those of a 2-step run), marked partial."""
  full = quality_bench.run(_args(tmp_path / 'full', '--steps', '4'),
                           _config())
  stopped = quality_bench.run(
      _args(tmp_path / 'stopped', '--steps', '4', '--stop_at', '2'),
      _config())
  assert stopped.result['partial'] and 'partial' not in full.result
  assert stopped.result['steps'] == 4 and stopped.state.step == 2
  assert len(stopped.step_seconds) == 2
  for got, want in zip(stopped.result['curve'], full.result['curve'][:2],
                       strict=True):
    got.pop('wall_s'), want.pop('wall_s')
    assert got == want
  with pytest.raises(ValueError, match='--stop_at'):
    quality_bench.run(_args(tmp_path / 'bad', '--steps', '2', '--stop_at',
                            '3'), _config())


def test_seed_gives_another_replicate(quality_run, tmp_path):
  _, run = quality_run
  other = quality_bench.run(_args(tmp_path, '--seed', '1'), _config())
  assert [r['step'] for r in other.result['curve']] == [1, 2]
  assert all(got['val_psnr'] != want['val_psnr'] for got, want in
             zip(other.result['curve'], run.result['curve']))
  want = dict(fused_mlp.flatten_tree(run.state.params))
  assert not all(torch.equal(t, want[path]) for path, t in
                 fused_mlp.flatten_tree(other.state.params))


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
  run = serve_bench.run(serve_bench.parse_args(_serve_argv(tmp_path, hd)),
                        _config())
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


# ------------------------------------------------------------ two ranks

WORLD = 2
HD_SIZE = (32, 18)
# The ranks average their halves' gradients where one process takes the
# whole batch's mean: the same function, summed in another order.
RTOL, ATOL = 2e-5, 1e-6
# The curve rounds PSNR to 5 places and serve_bench to 3.
CURVE_ATOL = 2e-5
SERVE_ATOL = 2e-3


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory, quality_run):
  """Both benches on 2 gloo ranks (a scene of their own, written by rank
  0), and serve_bench in this process on the 1-process run's npz."""
  tmp_path = tmp_path_factory.mktemp('ranks')
  inputs = dict(
      config=_config(), hd_size=HD_SIZE,
      quality_argv=_argv(tmp_path),
      serve_argv=_serve_argv(tmp_path),
      odd_batch_argv=_argv(tmp_path / 'odd', '--batch_size', '65'))
  ranks = torch_bench_workers.spawn(inputs, str(tmp_path), world=WORLD)
  one_dir, _ = quality_run
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(serve_bench, 'HD_SIZE', HD_SIZE)
    one_serve = serve_bench.run(
        serve_bench.parse_args(_serve_argv(one_dir)), _config())
  return tmp_path, ranks, one_serve


def _ok(result):
  status, value = result
  assert status == 'ok', value
  return value


def test_two_ranks_give_the_curve_and_npz_of_one_process(two_ranks,
                                                          quality_run):
  tmp_path, ranks, _ = two_ranks
  one_dir, one = quality_run
  want_curve = json.loads((one_dir / 'curve.json').read_text())['curve']
  got_curve = json.loads((tmp_path / 'curve.json').read_text())['curve']
  for rank in map(_ok, ranks):
    assert rank['world_size'] == WORLD
    # Each rank's own clock: every key but wall_s as written.
    assert [{k: v for k, v in row.items() if k != 'wall_s'}
            for row in rank['curve']] == [
                {k: v for k, v in row.items() if k != 'wall_s'}
                for row in got_curve]
    for row in rank['curve']:
      assert np.isfinite(row['wall_s']) and row['wall_s'] > 0
  assert [r['step'] for r in got_curve] == [r['step'] for r in want_curve]
  for got, want in zip(got_curve, want_curve):
    assert set(got) == CURVE_KEYS
    for key in CURVE_KEYS - {'wall_s'}:
      if want[key] is None:
        assert got[key] is None, key
      else:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=CURVE_ATOL, err_msg=key)
  with np.load(tmp_path / 'params.npz') as got, np.load(
      one_dir / 'params.npz') as want:
    assert set(got.files) == set(want.files)
    for key in want.files:
      np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                                 err_msg=key)
  for rank in map(_ok, ranks):  # every rank ends with the same params
    for path, t in fused_mlp.flatten_tree(one.state.params):
      np.testing.assert_allclose(rank['params']['/'.join(path)].numpy(),
                                 t.detach().numpy(), rtol=RTOL, atol=ATOL)


def test_two_ranks_serve_the_psnrs_of_one_process(two_ranks):
  tmp_path, ranks, one_serve = two_ranks
  written = json.loads((tmp_path / 'serve_True.json').read_text())
  want = one_serve.result
  quality = [(r['mode'], r['psnr'], r['ms_ssim']) for r in written['modes']]
  for rank in map(_ok, ranks):  # the times are each rank's own
    assert [(r['mode'], r['psnr'], r['ms_ssim'])
            for r in rank['modes']] == quality
    assert rank['grid'] == written['grid'] == want['grid']
  assert [r['mode'] for r in written['modes']] == [
      r['mode'] for r in want['modes']]
  for got, ref in zip(written['modes'], want['modes']):
    for key in ('psnr', 'ms_ssim'):
      np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                 atol=SERVE_ATOL, err_msg=got['mode'])
    assert np.isfinite(got['measured_1080p_s'])


def test_only_rank_zero_writes(two_ranks):
  tmp_path, ranks, _ = two_ranks
  first, other = (_ok(r)['writes'] for r in ranks)
  # The scene once; a checkpoint and an npz at each of 2 evals and the
  # end's npz; the curve at each eval and at the end, and serve's result.
  assert first['scene'] == 1
  assert first['checkpoint'] == 2
  assert first['savez'] == 3
  assert first['write_text'] >= 4
  assert other == {}
  assert sorted(p.name for p in (tmp_path / 'work').iterdir()) == ['1', '2']


def test_two_ranks_refuse_an_indivisible_batch(two_ranks):
  tmp_path, ranks, _ = two_ranks
  for rank in map(_ok, ranks):
    assert rank['odd_batch'] == ('Batch size must be divisible by the '
                                 'number of devices.')
  assert not (tmp_path / 'odd').exists()
