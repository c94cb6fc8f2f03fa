"""The port's training CLI against the JAX package's train.py, on the CPU.

On a small synthetic scene with configs/test_local.gin, the fused-path
bindings and small widths: the port's set-up (`train.setup`) and the
steps of train.py:98-205 done with the JAX modules give the same configs,
schedules, model switches and first batches; with JAX's params carried
across by `interop`, one step with deterministic sampling and the
background draws given matches JAX's train_step (stats at rtol 0.05, atol
5e-4; gradients at cosine > 0.95, norm ratio in (0.7, 1.4), as
tests/test_torch_training.py). A subprocess run of the CLI takes 3 steps
and resumes to 5.
"""

import argparse
import os
import pathlib
import subprocess
import sys
from unittest import mock

import jax
from jax import random
import numpy as np
import pytest
import torch

from nerfies_tpu import configs as jax_configs
from nerfies_tpu import datasets as jax_datasets
from nerfies_tpu import minigin as jax_gin
from nerfies_tpu import schedules as jax_schedules
from nerfies_tpu import training as jax_training
from nerfies_tpu.datasets import core as jax_core
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import train
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.ops import fused_mlp
from tests import torch_parity

REPO = pathlib.Path(__file__).resolve().parents[1]
GIN = str(REPO / 'configs' / 'test_local.gin')
BINDINGS = [
    'ModelConfig.use_fused_mlp = True',
    'ModelConfig.use_stratified_sampling = False',
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
    'TrainConfig.use_background_loss = True',
    'TrainConfig.background_points_batch_size = 24',
    'TrainConfig.max_steps = 3',
    'TrainConfig.save_every = 2',
    'TrainConfig.print_every = 1',
]
SCHEDULE_STEPS = (0, 1, 2, 3, 10, 1000, 50000, 80000, 150000, 200000)


@pytest.fixture(scope='module')
def scene_dir(tmp_path_factory):
  path = tmp_path_factory.mktemp('scene')
  synthetic.write_synthetic_dataset(path, num_train=4, num_val=1,
                                    image_size=(24, 16), num_points=64,
                                    motion_amplitude=0.05)
  return path


@pytest.fixture(autouse=True)
def _clear_gin():
  yield
  gin.clear_config()
  jax_gin.clear_config()


def _jax_setup(data_dir):
  """train.py:98-205 with the JAX modules, on one process.

  The params come from numpy (torch_parity.random_params) over the shapes
  of construct_nerf, in place of the Flax init.
  """
  jax_gin.clear_config()
  jax_gin.add_search_path('configs')
  jax_gin.parse_config_files_and_bindings(config_files=[GIN],
                                          bindings=BINDINGS)
  exp_config = jax_configs.ExperimentConfig()
  model_config = jax_configs.ModelConfig()
  train_config = jax_configs.TrainConfig()
  datasource = jax_datasets.from_config(
      {'type': exp_config.datasource_type, 'data_dir': str(data_dir)},
      image_scale=exp_config.image_scale,
      use_appearance_id=model_config.use_appearance_metadata,
      use_camera_id=model_config.use_camera_metadata,
      use_warp_id=model_config.use_warp,
      use_time=model_config.warp_metadata_encoder_type == 'time',
      random_seed=exp_config.random_seed,
      **dict(exp_config.datasource_kwargs))
  train_iter = datasource.create_iterator(
      datasource.train_ids, flatten=True, shuffle=True,
      batch_size=train_config.batch_size, prefetch_size=3)
  points = datasource.load_points(shuffle=True)
  points_iter = jax_core.iterator_from_arrays(
      points, batch_size=min(len(points),
                             train_config.background_points_batch_size),
      shuffle=True, seed=exp_config.random_seed, prefetch_size=3)
  scheds = {
      'learning_rate': train_config.lr_schedule,
      'warp_alpha': train_config.warp_alpha_schedule,
      'time_alpha': train_config.time_alpha_schedule,
      'elastic_loss_weight': train_config.elastic_loss_weight_schedule,
  }
  scheds = {k: jax_schedules.from_config(v) for k, v in scheds.items()}
  model, shapes = torch_parity.jax_model_and_shapes(
      model_config, appearance_ids=datasource.appearance_ids,
      camera_ids=datasource.camera_ids, warp_ids=datasource.warp_ids,
      near=datasource.near, far=datasource.far,
      use_warp_jacobian=(train_config.use_elastic_loss
                         and train_config.elastic_reduce_method != 'median'),
      use_weights=train_config.use_elastic_loss)
  params = torch_parity.random_params(shapes, seed=11)
  return dict(exp_config=exp_config, model_config=model_config,
              train_config=train_config, train_iter=train_iter,
              points_iter=points_iter, schedules=scheds, model=model,
              params=params)


def _args(base_folder, data_dir, bindings=()):
  return argparse.Namespace(
      base_folder=str(base_folder), data_dir=str(data_dir),
      gin_configs=[GIN], gin_bindings=BINDINGS + list(bindings),
      profile_dir=None, device='cpu')


def _comparable(config):
  return {k: getattr(v, '__name__', v) if callable(v) else v
          for k, v in vars(config).items()}


@pytest.fixture(scope='module')
def both(scene_dir, tmp_path_factory):
  """The two set-ups on one scene, and the first 3 batches of each."""
  exp = tmp_path_factory.mktemp('exp')
  run = train.setup(_args(exp, scene_dir))
  want = _jax_setup(scene_dir)
  batches = []
  for _ in range(3):
    got = next(run.train_iter)
    got['background_points'] = next(run.points_iter)
    jbatch = next(want['train_iter'])
    jbatch['background_points'] = next(want['points_iter'])
    batches.append((got, jbatch))
  return dict(run=run, want=want, batches=batches,
              config_gin=(exp / 'config.gin').read_text(),
              jax_operative=jax_gin.operative_config_str())


def test_setup_matches_jax(both):
  run, want = both['run'], both['want']
  for name in ('exp_config', 'model_config', 'train_config'):
    assert _comparable(getattr(run, name)) == _comparable(want[name]), name
  for name, sched in want['schedules'].items():
    assert [run.schedules[name](s) for s in SCHEDULE_STEPS] == [
        sched(s) for s in SCHEDULE_STEPS], name
  for attr in ('appearance_ids', 'camera_ids', 'warp_ids', 'near', 'far',
               'use_warp_jacobian', 'use_weights'):
    assert getattr(run.model, attr) == getattr(want['model'], attr), attr
  assert run.init_step == 1 and run.state.step == 0
  assert both['config_gin'] == both['jax_operative']


def test_first_batches_match_jax(both):
  for got, want in both['batches']:
    jax.tree.map(np.testing.assert_array_equal, got, want)


def test_first_step_matches_jax(both):
  """Step 1 of the loop (train.py:221-243) on the first batch."""
  run, want = both['run'], both['want']
  batch = both['batches'][0][1]
  step = 1
  train_config = run.train_config
  scalars = dict(
      learning_rate=run.schedules['learning_rate'](step),
      elastic_loss_weight=run.schedules['elastic_loss_weight'](step),
      warp_reg_loss_weight=train_config.warp_reg_loss_weight,
      warp_reg_loss_alpha=train_config.warp_reg_loss_alpha,
      warp_reg_loss_scale=train_config.warp_reg_loss_scale,
      background_loss_weight=train_config.background_loss_weight)
  alphas = dict(warp_alpha=run.schedules['warp_alpha'](step),
                time_alpha=run.schedules['time_alpha'](step))
  switches = dict(
      use_elastic_loss=train_config.use_elastic_loss,
      elastic_reduce_method=train_config.elastic_reduce_method,
      elastic_loss_type=train_config.elastic_loss_type,
      use_background_loss=train_config.use_background_loss,
      use_warp_reg_loss=train_config.use_warp_reg_loss)
  jmodel = want['model']
  key = random.fold_in(random.PRNGKey(run.exp_config.random_seed), step)
  jstate = jax_training.create_train_state(want['params'], **alphas)
  jax_step = jax.jit(jax_training.train_step, static_argnums=(0,),
                     static_argnames=tuple(switches))
  jnew, jstats, _ = jax_step(jmodel, key, jstate, batch,
                             jax_training.ScalarParams(**scalars), **switches)
  num_points = len(batch['background_points'])
  choice_key, noise_key = random.split(random.split(key, 4)[3])
  ids = random.choice(choice_key, jax.numpy.asarray(jmodel.warp_ids,
                                                    jax.numpy.uint32),
                      shape=(num_points, 1))
  noise = random.normal(noise_key, (num_points, 3))
  draws = (torch.from_numpy(np.asarray(ids).astype(np.int64)),
           torch.from_numpy(np.array(noise)))

  state = training.create_train_state(
      interop.params_from_jax(want['params'], device='cpu'), **alphas)
  step_fn = training.make_train_step(run.model, train_config, device='cpu')
  new_state, stats = step_fn(None, state, batch,
                             training.ScalarParams(**scalars), draws)
  want_stats = {'/'.join(k.key for k in path): float(v) for path, v in
                jax.tree_util.tree_flatten_with_path(jstats)[0]}
  got_stats = {'/'.join(path): float(v)
               for path, v in fused_mlp.flatten_tree(stats)}
  assert set(got_stats) == set(want_stats)
  for name, value in want_stats.items():
    np.testing.assert_allclose(got_stats[name], value, rtol=0.05, atol=5e-4,
                               err_msg=name)
  torch_parity.grad_check(new_state.opt_state.mu, jnew.opt_state.mu,
                          'gradient')


def _run_cli(base_folder, data_dir, max_steps, bindings=tuple(BINDINGS)):
  """`python -m nerfies_tpu_torch.train` in a subprocess, on the CPU.

  TensorFlow is kept out: TensorBoard's writer would import it when it is
  installed, which costs seconds and changes nothing the test reads.
  """
  argv = ['--base_folder', str(base_folder), '--data_dir', str(data_dir),
          '--device', 'cpu', '--gin_configs', GIN]
  for binding in list(bindings) + [f'TrainConfig.max_steps = {max_steps}',
                                   'TrainConfig.log_every = 2',
                                   'TrainConfig.histogram_every = 2']:
    argv += ['--gin_bindings', binding]
  code = ('import runpy, sys; sys.modules["tensorflow"] = None; '
          f'sys.argv = ["train"] + {argv!r}; '
          'runpy.run_module("nerfies_tpu_torch.train", run_name="__main__", '
          'alter_sys=True)')
  env = dict(os.environ, PYTHONPATH=str(REPO))
  return subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300,
                        check=False)


def test_cli_trains_saves_and_resumes(scene_dir, tmp_path):
  exp = tmp_path / 'exp'
  first = _run_cli(exp, scene_dir, 3)
  assert first.returncode == 0, first.stderr[-3000:]
  assert 'Starting training from step 1' in first.stderr
  assert (exp / 'config.gin').is_file()
  ckpts = exp / 'checkpoints'
  assert sorted(p.name for p in ckpts.iterdir()) == ['2', '3']
  second = _run_cli(exp, scene_dir, 5)
  assert second.returncode == 0, second.stderr[-3000:]
  assert 'Starting training from step 4' in second.stderr
  assert 'step=5,' in second.stderr and 'step=3,' not in second.stderr
  # Saves at 4 (save_every) and 5 (the end); the 2 newest are kept.
  assert sorted(p.name for p in ckpts.iterdir()) == ['4', '5']
  state = torch.load(ckpts / '5' / 'state.pt', weights_only=True)
  assert state['step'] == 5 and state['opt_state']['count'] == 5
  # Scalars and the embedding histograms at steps 2 and 4 (when
  # TensorBoard is installed; the CLI logs to the console otherwise).
  assert any((exp / 'summaries' / 'train').iterdir())


def test_cli_trains_test_local_through_the_plain_route(scene_dir, tmp_path,
                                                       monkeypatch):
  """configs/test_local.gin without the use_fused_mlp binding (the verify
  recipe's small bindings, stratified as the file says) trains through
  NerfModel.forward, as JAX trains it through model.apply; the eval CLI
  then evaluates its checkpoint once. With a trunk condition, which the
  serving path does not cover, eval renders through the forward too, and
  --fast_preview renders unculled, as in JAX (eval.py:352-360)."""
  from nerfies_tpu_torch import eval as eval_cli
  for cli in (train, eval_cli):
    monkeypatch.setattr(cli, '_make_summary_writer', lambda _: None)
  plain = [b for b in BINDINGS if 'use_fused_mlp' not in b
           and 'use_stratified_sampling' not in b]
  exp = tmp_path / 'exp'
  with mock.patch.object(training.fused_train, 'model_forward',
                         side_effect=AssertionError('fused route')):
    argv = ['--base_folder', str(exp), '--data_dir', str(scene_dir),
            '--device', 'cpu', '--gin_configs', GIN]
    for binding in plain + ['TrainConfig.max_steps = 2',
                            'ModelConfig.use_trunk_condition = True']:
      argv += ['--gin_bindings', binding]
    result = train.main(argv)
  assert not result.setup.model.fused_route
  assert result.setup.model.use_stratified_sampling
  assert result.state.step == 2
  for path, value in fused_mlp.flatten_tree(result.stats):
    assert np.isfinite(value), path
  assert 'elastic' in ' '.join('/'.join(p) for p, _ in
                               fused_mlp.flatten_tree(result.stats))
  with mock.patch.object(eval_cli.evaluation.fast_render, 'render_rays',
                         side_effect=AssertionError('serving path')):
    evaluated = eval_cli.main(argv + ['--fast_preview'] + [
        a for b in ('EvalConfig.eval_once = True',
                    'EvalConfig.num_val_eval = 1',
                    'EvalConfig.num_train_eval = 1',
                    'EvalConfig.num_test_eval = 1', 'EvalConfig.chunk = 100')
        for a in ('--gin_bindings', b)])
  assert set(evaluated.metrics[2]) >= {'val', 'train'}
  assert not evaluated.bakes
  assert np.isfinite(evaluated.metrics[2]['val']['psnr'])


def test_cli_needs_a_card_unless_told_cpu(scene_dir, tmp_path):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is valid')
  with pytest.raises(RuntimeError, match='device="cpu"'):
    train.main(['--base_folder', str(tmp_path / 'exp'), '--data_dir',
                str(scene_dir), '--gin_configs', GIN])
  assert not (tmp_path / 'exp').exists()


def test_profile_dir_records_steps_10_to_20(scene_dir, tmp_path,
                                            monkeypatch):
  monkeypatch.setattr(train, '_make_summary_writer', lambda _: None)
  argv = ['--base_folder', str(tmp_path / 'exp'), '--data_dir',
          str(scene_dir), '--device', 'cpu', '--gin_configs', GIN,
          '--profile_dir', str(tmp_path / 'profile')]
  for binding in BINDINGS + ['TrainConfig.max_steps = 21',
                             'TrainConfig.save_every = 100',
                             'TrainConfig.print_every = 100',
                             'TrainConfig.use_elastic_loss = False']:
    argv += ['--gin_bindings', binding]
  result = train.main(argv)
  assert result.state.step == 21 and result.setup.init_step == 1
  assert [p.name for p in (tmp_path / 'profile').iterdir()] == [
      'trace_to_step_21.json']
  assert sorted(p.name for p in (tmp_path / 'exp' / 'checkpoints').iterdir()
                ) == ['21']
  assert set(result.stats) == {'coarse', 'fine', 'background_loss'}


def test_the_cli_profile_holds_the_spans_of_its_timed_phases(
    scene_dir, tmp_path, monkeypatch):
  """The loop's TimeTracker phases 'data' and 'train_step' lie over the
  spans that the iterators and the step open: the trace of steps 11-12
  holds a `train.step` a step, with its phases, and the iterators'
  `data.wait`s outside them."""
  import json
  monkeypatch.setattr(train, '_make_summary_writer', lambda _: None)
  argv = ['--base_folder', str(tmp_path / 'exp'), '--data_dir',
          str(scene_dir), '--device', 'cpu', '--gin_configs', GIN,
          '--profile_dir', str(tmp_path / 'profile')]
  for binding in BINDINGS + ['TrainConfig.max_steps = 12',
                             'TrainConfig.save_every = 100',
                             'TrainConfig.print_every = 100']:
    argv += ['--gin_bindings', binding]
  result = train.main(argv)
  assert result.state.step == 12
  path = tmp_path / 'profile' / 'trace_to_step_13.json'
  events = json.loads(path.read_text())
  events = events['traceEvents'] if isinstance(events, dict) else events
  names = [e['name'] for e in events if e.get('cat') == 'user_annotation']
  assert names.count('train.step') == 2
  for name in ('train.to_device', 'train.forward', 'train.loss',
               'train.backward', 'train.optimizer'):
    assert names.count(name) == 2, name
  # Step 12's rays and background points: the profiler starts after
  # step 11's batch is drawn, and no batch is drawn after step 12.
  assert names.count('data.wait') == 2
  assert len(result.time_tracker.values('train_step')) == 12


def test_streaming_pool_through_datasource_kwargs(scene_dir, tmp_path):
  """`preload=False` reaches the streaming pool through
  ExperimentConfig.datasource_kwargs, as in JAX (core.py:579-597)."""
  binding = "ExperimentConfig.datasource_kwargs = {'preload': False}"
  run = train.setup(_args(tmp_path / 'exp', scene_dir, [binding]))
  assert run.datasource.preload is False
  want = jax_datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene_dir)}, image_scale=1,
      use_appearance_id=True, use_camera_id=False, use_warp_id=True,
      use_time=False, random_seed=run.exp_config.random_seed, preload=False)
  want_iter = want.create_iterator(want.train_ids, flatten=True, shuffle=True,
                                   batch_size=32, prefetch_size=3)
  for _ in range(3):
    jax.tree.map(np.testing.assert_array_equal, next(run.train_iter),
                 next(want_iter))
