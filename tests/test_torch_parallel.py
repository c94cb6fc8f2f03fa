"""The port's data parallelism (nerfies_tpu_torch/parallel) on the CPU.

Two gloo ranks, started once with torch.multiprocessing
(tests/torch_parallel_workers.py), run every case; the same cases run at
world size 1 in this process. A tiny model (NeRF depth 2, width 16, 8 + 8
samples). The tolerances are tests/test_multiprocess.py's for 2 ranks
against 1 (rtol 2e-5, atol 1e-6) and tests/test_torch_training.py's
against JAX's step: the plain route at rtol 1e-4, atol 1e-6 (gradients
at cosine 0.9999, norm ratio 1 +- 1e-3), the fused route through the
kernels' plain versions at rtol 0.05, atol 5e-4 (cosine 0.95, norm ratio
in (0.7, 1.4)). The JAX step runs sharded over the 8-device CPU mesh of
tests/conftest.py, its background draws handed to the port.
"""

import os
import pathlib
import subprocess
import sys

import jax
from jax import random
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfies_tpu import configs as jax_configs
from nerfies_tpu import training as jax_training
from nerfies_tpu.datasets import core as jax_core
from nerfies_tpu.parallel import mesh as jax_mesh
from nerfies_tpu_torch import camera
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import train
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.ops import mathutils
from nerfies_tpu_torch.parallel import mesh
from tests import torch_parallel_workers as workers
from tests.test_fused_train import _batch
from tests.test_fused_train import _build
from tests.test_torch_training import _jax_background_draws
from tests.torch_parity import grad_check
from tests.torch_parity import model_pair
from tests.torch_parity import ray_batch
from tests.torch_parity import SMALL_IDS
from tests.torch_parity import SMALL_MODEL

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
RTOL, ATOL = 2e-5, 1e-6

TINY = dict(
    num_coarse_samples=8, num_fine_samples=8, nerf_trunk_depth=2,
    nerf_trunk_width=16, nerf_rgb_branch_depth=1, nerf_rgb_branch_width=16,
    nerf_skips=(1,), num_nerf_point_freqs=4, num_nerf_viewdir_freqs=2,
    use_warp=True, warp_field_type='se3', num_warp_freqs=2,
    num_warp_features=2,
    warp_kwargs={'trunk_depth': 2, 'trunk_width': 16, 'skips': ()},
    use_appearance_metadata=True, use_stratified_sampling=True,
    noise_std=0.1, use_bfloat16=False, use_fused_mlp=False,
    sigma_activation='softplus')
IDS = dict(appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1, 2),
           near=0.5, far=3.0)
# The port's model of tests/test_fused_train.py _build (torch_parity.
# port_model), as plain fields for the spawned ranks.
FUSED_MODEL = dict(
    num_coarse_samples=6, num_fine_samples=6, nerf_trunk_depth=3,
    nerf_trunk_width=32, nerf_rgb_branch_depth=1, nerf_rgb_branch_width=16,
    nerf_skips=(2,), num_nerf_point_freqs=3, num_nerf_viewdir_freqs=2,
    num_warp_freqs=2, use_warp=True, warp_field_type='se3',
    warp_kwargs={'trunk_depth': 3, 'skips': (2,)},
    use_appearance_metadata=True, use_alpha_condition=True,
    use_rgb_condition=True, sigma_activation='softplus',
    use_stratified_sampling=False, noise_std=None, use_bfloat16=True,
    use_fused_mlp=True)
FUSED_IDS = dict(appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
                 near=0.5, far=3.0)
JAX_RAYS, JAX_POINTS = 16, 32
SWITCHES = dict(use_elastic_loss=True, elastic_reduce_method='weight',
                use_background_loss=True)


def _rays(num_rays, seed):
  """A global batch of rays, colours and ids of IDS."""
  batch = ray_batch(num_rays, seed=seed)
  rng = np.random.RandomState(seed + 100)
  batch['metadata'].pop('time')
  batch['metadata']['camera'][:] = 0
  batch['metadata']['appearance'] %= 2
  batch['rgb'] = rng.uniform(size=(num_rays, 3)).astype(np.float32)
  batch['background_points'] = rng.normal(size=(8, 3)).astype(np.float32)
  return batch


def _train_case():
  return dict(config=TINY, ids=IDS, seed=3, warp_alpha=1.5,
              switches=dict(SWITCHES),
              scalars=dict(learning_rate=1e-2, elastic_loss_weight=0.01,
                           background_loss_weight=1.0),
              batches=[_rays(16, seed) for seed in range(3)])


def _jax_step(jmodel, jparams, batch, scalars):
  """JAX's compile_train_step over the 8-device mesh: stats, first Adam
  moment, and the background draws of its key, for the port."""
  key = random.PRNGKey(7)
  mesh = jax_mesh.create_mesh()
  assert mesh.size == 8
  step = jax_training.compile_train_step(
      jmodel, jax_configs.TrainConfig(batch_size=JAX_RAYS, **SWITCHES), mesh)
  state = jax.device_put(
      jax_training.create_train_state(jparams, warp_alpha=1.5),
      jax_mesh.replicated_sharding(mesh))
  new, stats, _ = step(key, state, batch,
                       jax_training.ScalarParams(**scalars))
  draws = _jax_background_draws(jmodel, random.split(key, 4)[3], JAX_POINTS)
  want = {'/'.join(k.key for k in path): float(v) for path, v in
          jax.tree_util.tree_flatten_with_path(jax.device_get(stats))[0]}
  return want, jax.device_get(new.opt_state.mu), draws


def _jax_plain_case():
  """configs/gpu_*'s route: model.apply against NerfModel.forward, the
  warp heads scaled by 0.1 (tests/test_torch_training.py)."""
  jmodel, jparams, _, _ = model_pair(
      seed=0, use_warp_jacobian=True, use_weights=True,
      use_appearance_metadata=True, use_rgb_condition=True)
  jparams = jax.tree_util.tree_map_with_path(
      lambda path, leaf: (0.1 * leaf if 'branches' in jax.tree_util.keystr(
          path) else leaf), jparams)
  batch = ray_batch(JAX_RAYS, seed=4)
  rng = np.random.RandomState(10)
  batch['rgb'] = rng.uniform(size=(JAX_RAYS, 3)).astype(np.float32)
  batch['background_points'] = rng.normal(size=(JAX_POINTS, 3)).astype(
      np.float32)
  scalars = dict(learning_rate=1e-3, elastic_loss_weight=0.01,
                 background_loss_weight=1.0)
  want, mu, draws = _jax_step(jmodel, jparams,
                              jax.tree.map(jnp.asarray, batch), scalars)
  case = dict(config=dict(SMALL_MODEL, use_appearance_metadata=True,
                          use_rgb_condition=True),
              ids=SMALL_IDS, params=interop.params_from_jax(jparams, 'cpu'),
              warp_alpha=1.5, switches=dict(SWITCHES), scalars=scalars,
              batch=batch, draws=draws)
  return case, (want, mu)


def _jax_fused_case():
  """The fused route: JAX's Pallas kernels in interpret mode against the
  port's kernels' plain versions."""
  jmodel, jparams = _build()
  batch = _batch(JAX_RAYS, seed=2)
  batch['background_points'] = np.random.RandomState(6).normal(
      size=(JAX_POINTS, 3)).astype(np.float32)
  scalars = dict(learning_rate=1e-3, elastic_loss_weight=0.01,
                 background_loss_weight=1.0)
  want, mu, draws = _jax_step(jmodel, jparams, batch, scalars)
  case = dict(config=FUSED_MODEL, ids=FUSED_IDS,
              params=interop.params_from_jax(jparams, 'cpu'), warp_alpha=1.5,
              switches=dict(SWITCHES), scalars=scalars, batch=batch,
              draws=draws)
  return case, (want, mu)


def _pool_arrays(num_rays=100, num_images=4, seed=0):
  rng = np.random.RandomState(seed)
  return dict(
      directions=rng.normal(size=(num_rays, 3)).astype(np.float32),
      rgb=rng.randint(0, 256, (num_rays, 3)).astype(np.uint8),
      image_idx=np.sort(rng.randint(0, num_images, num_rays)).astype(
          np.int32),
      origins=rng.normal(size=(num_images, 3)).astype(np.float32),
      metadata={'warp': np.arange(num_images, dtype=np.uint32)[:, None],
                'time': rng.uniform(size=(num_images, 1)).astype(
                    np.float32)})


def _render_case():
  h, w = 5, 7
  rays = ray_batch(h * w, seed=9)
  rays['metadata'].pop('time')
  rays['metadata']['camera'][:] = 0
  rays['metadata']['appearance'] %= 2
  rays = {k: (v.reshape(h, w, -1) if not isinstance(v, dict) else
              {kk: vv.reshape(h, w, -1) for kk, vv in v.items()})
          for k, v in rays.items()}
  cam = camera.Camera(orientation=np.eye(3), position=np.zeros(3),
                      focal_length=6.0, principal_point=np.array([3.5, 2.5]),
                      image_size=np.array([w, h]))
  return dict(config=TINY, ids=IDS, seed=1, warp_alpha=1.5, rays=rays,
              camera=cam, metadata_ids={'warp': 1, 'appearance': 0,
                                        'camera': 0},
              chunk=24)


@pytest.fixture(scope='module')
def scene_dir(tmp_path_factory):
  path = tmp_path_factory.mktemp('scene')
  synthetic.write_synthetic_dataset(path, num_train=4, num_val=1,
                                    image_size=(24, 16), num_points=64,
                                    motion_amplitude=0.05)
  return path


GIN = str(REPO / 'configs' / 'test_local.gin')
CLI_BINDINGS = (
    'ExperimentConfig.image_scale = 1',
    'TrainConfig.batch_size = 32',
    'TrainConfig.background_points_batch_size = 24',
    'TrainConfig.max_steps = 3',
    'TrainConfig.save_every = 2',
    'TrainConfig.print_every = 1',
    'ModelConfig.num_coarse_samples = 8',
    'ModelConfig.num_fine_samples = 8',
    'ModelConfig.nerf_trunk_depth = 2',
    'ModelConfig.nerf_trunk_width = 16',
    'ModelConfig.nerf_rgb_branch_width = 16',
    'ModelConfig.nerf_skips = ()',
    'ModelConfig.num_nerf_point_freqs = 3',
    'ModelConfig.num_nerf_viewdir_freqs = 2',
    'ModelConfig.num_warp_freqs = 2',
    "ModelConfig.warp_kwargs = {'trunk_depth': 2, 'skips': ()}",
)


def _cli_argv(exp, scene, *bindings):
  argv = ['--base_folder', str(exp), '--data_dir', str(scene), '--device',
          'cpu', '--gin_configs', GIN]
  for binding in CLI_BINDINGS + bindings:
    argv += ['--gin_bindings', binding]
  return argv


@pytest.fixture(scope='module')
def runs(tmp_path_factory, scene_dir):
  """Every case at world size 1 here and on 2 spawned gloo ranks, with
  the JAX step's results for the two parity cases."""
  jax_plain, want_plain = _jax_plain_case()
  jax_fused, want_fused = _jax_fused_case()
  inputs = {
      'train': _train_case(),
      'jax_plain': jax_plain,
      'jax_fused': jax_fused,
      'iterator': dict(pool=_pool_arrays(), batch_size=8, num_batches=3),
      'render': _render_case(),
      'occupancy': dict(config=dict(TINY, use_stratified_sampling=False),
                        ids=IDS, seed=2, resolution=12, threshold=0.75),
  }
  out = tmp_path_factory.mktemp('parallel')
  one = workers.run_all(inputs, str(out))
  gin.clear_config()
  inputs['batch_size'] = dict(argv=_cli_argv(
      out / 'exp_odd', scene_dir, 'TrainConfig.batch_size = 31'))
  ranks = workers.spawn(inputs, str(out), world=WORLD)
  gin.clear_config()
  return dict(one=one, ranks=ranks, jax_plain=want_plain,
              jax_fused=want_fused, inputs=inputs, out=out)


def _ok(result):
  status, value = result
  assert status == 'ok', value
  return value


def _same_tree(got, want, rtol, atol, tag):
  assert set(got) == set(want), tag
  for key in want:
    np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                               rtol=rtol, atol=atol, err_msg=f'{tag} {key}')


# ------------------------------------------------------------ arithmetic


@pytest.mark.parametrize('n', [0, 1, 5, 8, 13, 16, 6144, 6145, 8191])
@pytest.mark.parametrize('multiple', [1, 2, 3, 4, 8])
def test_pad_to_multiple_is_jax_arithmetic(n, multiple):
  assert mesh.pad_to_multiple(n, multiple) == jax_mesh.pad_to_multiple(
      n, multiple)


@pytest.mark.parametrize('batch', [8, 64, 6144, 3072])
@pytest.mark.parametrize('world,rank', [(1, 0), (2, 0), (2, 1), (4, 3),
                                        (8, 5)])
def test_local_batch_slice_is_jax_arithmetic(batch, world, rank,
                                             monkeypatch):
  monkeypatch.setattr(mesh, 'world_size', lambda: world)
  monkeypatch.setattr(mesh, 'rank', lambda: rank)
  monkeypatch.setattr(jax, 'process_count', lambda: world)
  monkeypatch.setattr(jax, 'process_index', lambda: rank)
  assert mesh.local_batch_slice(batch) == jax_mesh.local_batch_slice(batch)


def test_without_a_group_everything_is_world_size_one():
  assert not mesh.initialized()
  assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
  t = torch.arange(6.0)
  assert mesh.all_reduce_mean([t])[0] is t
  assert mesh.all_gather_rows(t) is t
  generator = torch.Generator()
  assert mesh.shard_generator(generator) is generator
  assert mesh.init('cpu') == torch.device('cpu')
  assert not mesh.initialized()


def test_rank_rows_draw_the_global_rows():
  """A RankRows stream gives rank r the rows r * n .. (r + 1) * n of the
  draw one process makes at n * world rows."""
  full = torch.rand((12, 5), generator=torch.Generator().manual_seed(4))
  for r in range(3):
    stream = mesh.RankRows(torch.Generator().manual_seed(4), r, 3)
    got = mesh.draw(torch.rand, (4, 5), stream)
    assert torch.equal(got, full[4 * r:4 * (r + 1)])


class _Event:
  """A stand-in for a torch.cuda.Event of all_reduce_mean's pairs."""

  def __init__(self, done=True, ms=0.0):
    self.done, self.ms, self.waited = done, ms, False

  def query(self):
    return self.done

  def synchronize(self):
    self.waited = self.done = True

  def elapsed_time(self, end):
    return end.ms


def test_collective_times_fold_as_their_events_complete(monkeypatch):
  """Each completed all-reduce event pair is added to the running sum
  and dropped, so a run of any length keeps only the pairs in flight;
  collective_stats waits for those."""
  done, running = (_Event(), _Event(True, 1.5)), (_Event(), _Event(False, 2.0))
  monkeypatch.setattr(mesh, '_COLLECTIVES', {
      'calls': 2, 'bytes': 8, 'ms': 0.25, 'pending': [done, running]})
  mesh._fold_events(wait=False)
  assert mesh._COLLECTIVES['pending'] == [running]
  assert mesh._COLLECTIVES['ms'] == 1.75
  assert mesh.collective_stats(reset=True) == {'calls': 2, 'bytes': 8,
                                               'ms': 3.75}
  assert running[1].waited
  assert mesh._COLLECTIVES == {'calls': 0, 'bytes': 0, 'ms': 0.0,
                               'pending': []}


# --------------------------------------------------------------- 2 ranks


def test_iterator_slices_match_jax(runs):
  """Rank r of 2 yields JAX's iterator_from_pool(process_index=r,
  process_count=2) bit for bit, and the ranks' slices make the 1-rank
  batches."""
  arrays = runs['inputs']['iterator']['pool']
  one = _ok(runs['one']['iterator'])
  ranks = [_ok(r['iterator']) for r in runs['ranks']]
  for r, got in enumerate(ranks):
    it = jax_core.iterator_from_pool(
        jax_core.RayPool(**arrays), 8, seed=3, prefetch_size=0,
        process_index=r, process_count=WORLD)
    for batch in got:
      want = next(it)
      flat_got = dict(_flatten(batch))
      for key, value in _flatten(want):
        np.testing.assert_array_equal(flat_got[key], value, err_msg=key)
  for i, whole in enumerate(one):
    for key, value in _flatten(whole):
      parts = [dict(_flatten(rank[i]))[key] for rank in ranks]
      np.testing.assert_array_equal(np.concatenate(parts), value)


def _flatten(tree, prefix=''):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _flatten(v, f'{prefix}{k}/')
    else:
      yield f'{prefix}{k}', np.asarray(v)


def test_two_ranks_train_the_params_of_one(runs):
  """3 stratified steps with the elastic ('weight') and background
  losses: the same params and stats (psnr included) on both ranks as on
  one."""
  one = _ok(runs['one']['train'])
  for rank in runs['ranks']:
    got = _ok(rank['train'])
    _same_tree(got['params'], one['params'], RTOL, ATOL, 'params')
    for step, (g, w) in enumerate(zip(got['stats'], one['stats'])):
      assert 'fine/metric/psnr' in w and 'coarse/loss/elastic' in w
      assert 'background_loss' in w
      _same_tree(g, w, RTOL, ATOL, f'stats of step {step}')


def test_psnr_is_derived_from_the_averaged_rgb_loss(runs):
  stats = _ok(runs['ranks'][0]['train'])['stats'][-1]
  for level in ('coarse', 'fine'):
    want = mathutils.compute_psnr(stats[f'{level}/loss/rgb'])
    assert float(stats[f'{level}/metric/psnr']) == pytest.approx(
        float(want), rel=1e-6)


def test_checkpoint_written_by_rank_zero_and_resumed_on_both(runs):
  """Only rank 0 calls torch.save; both ranks restore; the resumed run
  equals the unbroken one bit for bit."""
  saves = [_ok(rank['train'])['saves'] for rank in runs['ranks']]
  assert saves == [1, 0]
  for rank in runs['ranks']:
    got = _ok(rank['train'])
    for key, value in got['params'].items():
      assert torch.equal(got['resumed_params'][key], value), key


@pytest.mark.parametrize('route', ['plain', 'fused'])
def test_two_ranks_match_jax_on_the_eight_device_mesh(runs, route):
  """Deterministic sampling, one step of the global batch: 2 ranks of the
  port against JAX's compile_train_step sharded over 8 CPU devices."""
  want, mu = runs[f'jax_{route}']
  if route == 'plain':
    rtol, atol, check = 1e-4, 1e-6, dict(cos_floor=0.9999,
                                          ratio=(1 - 1e-3, 1 + 1e-3))
  else:
    rtol, atol, check = 0.05, 5e-4, {}
  for rank in runs['ranks']:
    got = _ok(rank[f'jax_{route}'])
    assert set(got['stats']) == set(want)
    for name, value in want.items():
      np.testing.assert_allclose(float(got['stats'][name]), value,
                                 rtol=rtol, atol=atol, err_msg=name)
    tree = {}
    for path, t in got['mu'].items():
      node = tree
      for key in path.split('/')[:-1]:
        node = node.setdefault(key, {})
      node[path.split('/')[-1]] = t
    grad_check(tree, mu, f'{route} gradient', **check)


@pytest.mark.parametrize('path', ['serve', 'stratified'])
@pytest.mark.parametrize('fn', ['image', 'camera'])
def test_two_ranks_render_the_image_of_one(runs, path, fn):
  """render_image and render_camera at 2 ranks equal 1 rank bit for bit,
  on every rank: the serving kernels' plain versions, and the plain
  forward of a stratified model, whose draws each rank slices."""
  one = _ok(runs['one']['render'])
  for rank in runs['ranks']:
    got = _ok(rank['render'])
    for key in ('rgb', 'depth', 'med_depth', 'acc'):
      name = f'{path}/{fn}/{key}'
      assert got[name].shape == one[name].shape
      np.testing.assert_array_equal(got[name], one[name], err_msg=name)


def test_indivisible_render_chunk_raises_jax_error(runs):
  assert _ok(runs['one']['render'])['indivisible'] is None
  for rank in runs['ranks']:
    message = _ok(rank['render'])['indivisible']
    assert message and 'must be divisible by the process count 2' in message


def test_occupancy_grid_is_the_same_on_every_rank(runs):
  """Each rank bakes the grid itself; the bake is deterministic, so every
  rank holds the 1-rank grid (no broadcast)."""
  one = _ok(runs['one']['occupancy'])['occupied']
  assert 0 < int(one.sum()) < one.numel()
  for rank in runs['ranks']:
    got = _ok(rank['occupancy'])
    assert torch.equal(got['occupied'], one)
    every = got['every_rank'].bool()
    assert every.shape[0] == WORLD
    assert all(torch.equal(row, one) for row in every)


def test_indivisible_batch_size_raises(runs):
  for rank in runs['ranks']:
    message = _ok(rank['batch_size'])
    assert message == ('Batch size must be divisible by the number of '
                       'devices.')


# -------------------------------------------------------------- torchrun


def test_torchrun_cli_trains_the_params_of_one_process(scene_dir, tmp_path,
                                                        monkeypatch):
  """python -m torch.distributed.run --nproc_per_node=2 -m
  nerfies_tpu_torch.train --device cpu: one config.gin, one checkpoint
  directory, one summary writer; its params equal those of the CLI in
  one process."""
  exp = tmp_path / 'ddp'
  # The same run as `-m nerfies_tpu_torch.train`, with TensorFlow kept out
  # of TensorBoard's writer (it only costs seconds).
  launcher = tmp_path / 'train_main.py'
  launcher.write_text(
      'import runpy, sys\n'
      'sys.modules["tensorflow"] = None\n'
      'runpy.run_module("nerfies_tpu_torch.train", run_name="__main__", '
      'alter_sys=True)\n')
  env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
  env.pop('WORLD_SIZE', None)
  proc = subprocess.run(
      [sys.executable, '-m', 'torch.distributed.run', '--standalone',
       f'--nproc_per_node={WORLD}', str(launcher),
       *_cli_argv(exp, scene_dir)],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
      check=False)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert proc.stderr.count('Starting training from step 1') == 1
  assert 'all-reduce over 2 ranks: 3 calls' in proc.stderr
  assert (exp / 'config.gin').is_file()
  assert sorted(p.name for p in (exp / 'checkpoints').iterdir()) == [
      '2', '3']
  writers = list((exp / 'summaries' / 'train').glob('events.out.*'))
  assert len(writers) == 1, writers

  monkeypatch.setattr(train, '_make_summary_writer', lambda _: None)
  single = train.main(_cli_argv(tmp_path / 'one', scene_dir))
  gin.clear_config()
  assert single.state.step == 3
  state = torch.load(exp / 'checkpoints' / '3' / 'state.pt',
                     weights_only=True)
  assert state['step'] == 3
  want = dict(workers._flat(single.state.params))
  got = dict(workers._flat(state['params']))
  _same_tree(got, want, RTOL, ATOL, 'torchrun params')


# ------------------------------------------------------------- launches


def test_each_launch_names_its_tensors_card(monkeypatch):
  """launch_target gives a launch the card of its tensors and that card's
  current stream, never card 0 by default; every wrapper launches
  through it."""
  from nerfies_tpu_torch.ops import _build
  asked = []

  class Stream:
    cuda_stream = 0xbeef

  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda index: asked.append(index) or Stream())
  monkeypatch.setattr(torch.cuda, 'current_device', lambda: 2)
  assert _build.launch_target(torch.device('cuda', 3)) == (3, 0xbeef)
  assert _build.launch_target(torch.device('cuda')) == (2, 0xbeef)
  assert asked == [3, 2]
  for name in ('fused_mlp.py', 'fused_warp.py'):
    source = (REPO / 'nerfies_tpu_torch' / 'ops' / name).read_text()
    assert 'current_stream' not in source and 'index or 0' not in source
    assert source.count('_build.launch_target(') >= 2, name


def test_launch_cards_are_kept_until_the_counts_reset(monkeypatch):
  """_build.launch_cards lists the cards launch_target gave a launch,
  which is what the ddp children report for each rank; resetting the
  launch counts forgets them."""
  from nerfies_tpu_torch.ops import _build
  from nerfies_tpu_torch.ops import fused_mlp

  class Stream:
    cuda_stream = 0xbeef

  monkeypatch.setattr(torch.cuda, 'current_stream', lambda index: Stream())
  monkeypatch.setattr(torch.cuda, 'current_device', lambda: 1)
  fused_mlp.reset_launch_counts()
  assert _build.launch_cards() == []
  for device in (torch.device('cuda', 3), torch.device('cuda'),
                 torch.device('cuda', 3)):
    _build.launch_target(device)
  assert _build.launch_cards() == [1, 3]
  fused_mlp.reset_launch_counts()
  assert _build.launch_cards() == []
