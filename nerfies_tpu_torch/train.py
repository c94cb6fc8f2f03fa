"""Training CLI of the port, on one card.

The counterpart of train.py (the JAX package's CLI) for one CUDA device:
the same flags, gin configs, data pipeline, schedules, logging cadence and
checkpoint layout, with each step through training.make_train_step (the
fused kernels, or NerfModel.forward where JAX runs `model.apply`):

  python -m nerfies_tpu_torch.train --base_folder EXP --data_dir SCENE \\
      --gin_configs configs/gpu_vrig_paper.gin

`--device cpu` runs on the CPU (the kernels' plain versions); without it
the CLI needs a card. Under `torchrun` it trains data-parallel over the
machine's cards (train.py:115-216 on a mesh), one process per card on
cuda:{LOCAL_RANK}:

  torchrun --standalone --nproc_per_node=4 -m nerfies_tpu_torch.train \
      --base_folder EXP --data_dir SCENE \
      --gin_configs configs/gpu_quarterhd_4gpu.gin

Each rank takes its contiguous 1/N of every global batch (and of the
background points batch, trimmed to a multiple of N), the step averages
gradients and stats in one all-reduce, and only rank 0 writes:
directories, config.gin, logs, TensorBoard and checkpoints. The batch
size must divide by the world size.

The step takes JAX's route: the fused kernels when `use_fused_mlp` is
set and the architecture is covered (as in configs/tpu_*.gin), the plain
forward otherwise (every configs/gpu_*.gin and test_*.gin). Only an
activation other than relu on the fused route is refused, before any
data is read.

The set-up (`setup`: configs through the restored state) and the loop
(`train`) are separate functions; `main` runs both and returns what they
made.
"""

import argparse
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import fused_train
from nerfies_tpu_torch import gpath
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch import training
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.datasets import core as datasets_core
from nerfies_tpu_torch.models import nerf as models
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.parallel import mesh

log = logging.getLogger('nerfies_tpu_torch.train')


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Trains a Nerfies model with the PyTorch port.')
  parser.add_argument('--base_folder', required=True,
                      help='where to store ckpts and logs')
  parser.add_argument('--data_dir', default=None,
                      help='input data directory.')
  parser.add_argument('--gin_bindings', action='append', default=None,
                      help='Gin parameter bindings.')
  parser.add_argument('--gin_configs', action='append', default=[],
                      help='Gin config files.')
  parser.add_argument('--profile_dir', default=None,
                      help='If set, record a torch.profiler trace of steps '
                      '10-20 after the first into this directory.')
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  return parser.parse_args(argv)


def parse_configs(gin_configs: Sequence[str],
                  gin_bindings: Optional[Sequence[str]] = None):
  """Parses the gin files and bindings into the four configs.

  Clears earlier bindings first, so a second call in one process parses
  afresh. Refuses a model config whose fused route the port cannot run
  (fused_train.check_trainable).

  Returns:
    (ExperimentConfig, ModelConfig, TrainConfig).
  """
  gin.clear_config()
  gin.add_search_path('configs')
  gin.parse_config_files_and_bindings(config_files=gin_configs,
                                      bindings=gin_bindings)
  exp_config = configs.ExperimentConfig()
  model_config = configs.ModelConfig()
  train_config = configs.TrainConfig()
  fused_train.check_trainable(model_config)
  return exp_config, model_config, train_config


def construct_model(model_config, train_config, datasource, seed: int,
                    device):
  """The model and params of train.py:174-190."""
  return models.construct_nerf(
      model_config,
      appearance_ids=datasource.appearance_ids,
      camera_ids=datasource.camera_ids,
      warp_ids=datasource.warp_ids,
      near=datasource.near,
      far=datasource.far,
      generator=torch.Generator().manual_seed(seed),
      device=device,
      # The gathered-median reduction linearizes the warp at each ray's
      # median-depth point inside the step instead of in the forward.
      use_warp_jacobian=(train_config.use_elastic_loss
                         and train_config.elastic_reduce_method != 'median'),
      use_weights=train_config.use_elastic_loss)


@dataclasses.dataclass
class Setup:
  """What the set-up made: configs, data, schedules, model and state."""
  exp_config: Any
  model_config: Any
  train_config: Any
  exp_dir: Any
  summary_dir: Any
  checkpoint_dir: Any
  device: torch.device
  datasource: Any
  train_iter: Any
  points_iter: Any
  schedules: Dict[str, schedules.Schedule]
  model: Any
  state: training.TrainState
  scalar_params: training.ScalarParams
  init_step: int
  # Seconds: 'ray_pool' (the train iterator's pool build) and 'restore'.
  timings: Dict[str, float]


def setup(args: argparse.Namespace) -> Setup:
  """train.py:98-205: configs through the restored state, on this
  process's device (joining the torchrun group, if any)."""
  device = mesh.init(args.device)
  if not mesh.is_main():
    log.setLevel(logging.WARNING)
  log.info('*** Starting experiment')
  exp_config, model_config, train_config = parse_configs(
      args.gin_configs, args.gin_bindings)

  exp_dir = gpath.GPath(args.base_folder)
  if exp_config.subname:
    exp_dir = exp_dir / exp_config.subname
  summary_dir = exp_dir / 'summaries' / 'train'
  checkpoint_dir = exp_dir / 'checkpoints'
  if mesh.is_main():
    for d in (exp_dir, summary_dir, checkpoint_dir):
      if not d.exists():
        d.mkdir(parents=True, exist_ok=True)
    config_str = gin.operative_config_str()
    log.info('Configuration: \n%s', config_str)
    with (exp_dir / 'config.gin').open('w') as f:
      f.write(config_str)
  log.info('Starting process %d of %d on %s.', mesh.rank(),
           mesh.world_size(), device)

  np.random.seed(exp_config.random_seed + mesh.rank())
  if train_config.batch_size % mesh.world_size() != 0:
    raise ValueError('Batch size must be divisible by the number of devices.')

  datasource_spec = exp_config.datasource_spec
  if datasource_spec is None:
    datasource_spec = {
        'type': exp_config.datasource_type,
        'data_dir': args.data_dir,
    }
  log.info('Creating datasource: %s', datasource_spec)
  datasource = datasets.from_config(
      datasource_spec,
      image_scale=exp_config.image_scale,
      use_appearance_id=model_config.use_appearance_metadata,
      use_camera_id=model_config.use_camera_metadata,
      use_warp_id=model_config.use_warp,
      use_time=model_config.warp_metadata_encoder_type == 'time',
      random_seed=exp_config.random_seed,
      **dict(exp_config.datasource_kwargs))
  start = time.perf_counter()
  train_iter = datasource.create_iterator(
      datasource.train_ids,
      flatten=True,
      shuffle=True,
      batch_size=train_config.batch_size,
      prefetch_size=3)
  timings = {'ray_pool': time.perf_counter() - start}

  points_iter = None
  if train_config.use_background_loss:
    points = datasource.load_points(shuffle=True)
    points_batch_size = min(len(points),
                            train_config.background_points_batch_size)
    points_batch_size -= points_batch_size % mesh.world_size()
    # Every rank draws the global points batch and keeps its rows.
    rows = mesh.local_batch_slice(points_batch_size)
    points_iter = (batch[rows] for batch in datasets_core.iterator_from_arrays(
        points, batch_size=points_batch_size, shuffle=True,
        seed=exp_config.random_seed, prefetch_size=3))

  scheds = {
      'learning_rate': schedules.from_config(train_config.lr_schedule),
      'warp_alpha': schedules.from_config(train_config.warp_alpha_schedule),
      'time_alpha': schedules.from_config(train_config.time_alpha_schedule),
      'elastic_loss_weight': schedules.from_config(
          train_config.elastic_loss_weight_schedule),
  }

  model, params = construct_model(model_config, train_config, datasource,
                                  exp_config.random_seed, device)
  state = training.create_train_state(
      params,
      warp_alpha=scheds['warp_alpha'](0),
      time_alpha=scheds['time_alpha'](0))
  scalar_params = training.ScalarParams(
      learning_rate=scheds['learning_rate'](0),
      elastic_loss_weight=scheds['elastic_loss_weight'](0),
      warp_reg_loss_weight=train_config.warp_reg_loss_weight,
      warp_reg_loss_alpha=train_config.warp_reg_loss_alpha,
      warp_reg_loss_scale=train_config.warp_reg_loss_scale,
      background_loss_weight=train_config.background_loss_weight)
  start = time.perf_counter()
  state = checkpoints.restore_checkpoint(checkpoint_dir, state)
  timings['restore'] = time.perf_counter() - start
  return Setup(exp_config, model_config, train_config, exp_dir, summary_dir,
               checkpoint_dir, device, datasource, train_iter, points_iter,
               scheds, model, state, scalar_params, state.step + 1, timings)


def _make_summary_writer(summary_dir):
  try:
    from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter(str(summary_dir))
  except ImportError:
    log.warning('No TensorBoard writer available; logging to console.')
    return None


def _to_host(stats) -> Dict[str, Any]:
  """Stats tensors -> Python floats, in one copy from the device."""
  flat = fused_mlp.flatten_tree(stats)
  values = torch.stack([t.float() for _, t in flat]).cpu().tolist()
  return fused_mlp.unflatten_tree([p for p, _ in flat], values)


def _log_to_tensorboard(writer, state, scalar_params, stats, time_dict):
  """Scalar logging, as train.py's `_log_to_tensorboard`."""
  if writer is None:
    return
  step = state.step
  writer.add_scalar('params/learning_rate', scalar_params.learning_rate, step)
  writer.add_scalar('params/warp_alpha', state.warp_alpha, step)
  writer.add_scalar('params/time_alpha', state.time_alpha, step)
  writer.add_scalar('params/elastic_loss/weight',
                    scalar_params.elastic_loss_weight, step)
  for branch in ('coarse', 'fine'):
    if branch not in stats:
      continue
    for stat_key, stat_value in stats[branch].items():
      writer.add_scalar(f'{stat_key}/{branch}', stat_value, step)
  if 'background_loss' in stats:
    writer.add_scalar('loss/background', stats['background_loss'], step)
  for k, v in time_dict.items():
    writer.add_scalar(f'time/{k}', v, step)


def _log_histograms(writer, model, state):
  """Embedding histograms, as train.py's `_log_histograms`."""
  if writer is None:
    return
  params = state.params
  tables = []
  if 'appearance_encoder' in params:
    tables.append(('appearance_embedding', params['appearance_encoder']))
  if 'camera_encoder' in params:
    tables.append(('camera_embedding', params['camera_encoder']))
  if 'warp_field' in params and model.warp_metadata_encoder_type == 'glo':
    tables.append(('warp_embedding',
                   params['warp_field']['metadata_encoder']))
  for name, encoder in tables:
    writer.add_histogram(
        name, encoder['embed']['embedding'].detach().cpu().numpy(),
        state.step)


@dataclasses.dataclass
class Result:
  """What a run made: its set-up, the final state, the last step's stats
  (on the host; None without a step) and its timings."""
  setup: Setup
  state: training.TrainState
  stats: Optional[Dict[str, Any]]
  time_tracker: utils.TimeTracker
  save_seconds: List[float]
  # mesh.collective_stats of the run: all-reduce calls, bytes and ms.
  collectives: Dict[str, Any] = dataclasses.field(default_factory=dict)


def train(run: Setup, args: argparse.Namespace) -> Result:
  """The loop of train.py:207-275: one step per batch to max_steps."""
  train_config = run.train_config
  scheds = run.schedules
  state = run.state
  scalar_params = run.scalar_params
  train_step = training.make_train_step(run.model, train_config, run.device)
  summary_writer = (_make_summary_writer(run.summary_dir) if mesh.is_main()
                    else None)
  if summary_writer:
    summary_writer.add_text('gin/train', gin.operative_config_str(), 0)

  save_seconds = []

  def save(state):
    start = time.perf_counter()
    checkpoints.save_checkpoint(run.checkpoint_dir, state)
    save_seconds.append(time.perf_counter() - start)

  log.info('Starting training from step %d', run.init_step)
  mesh.collective_stats(reset=True)
  profiler = None
  time_tracker = utils.TimeTracker()
  time_tracker.tic('data', 'total')

  step, host_stats = run.init_step - 1, None
  for step, batch in zip(range(run.init_step, train_config.max_steps + 1),
                         run.train_iter):
    if run.points_iter is not None:
      batch['background_points'] = next(run.points_iter)
    time_tracker.toc('data')
    scalar_params = dataclasses.replace(
        scalar_params,
        learning_rate=scheds['learning_rate'](step),
        elastic_loss_weight=scheds['elastic_loss_weight'](step))
    state = dataclasses.replace(state,
                                warp_alpha=scheds['warp_alpha'](step),
                                time_alpha=scheds['time_alpha'](step))

    if args.profile_dir and step == run.init_step + 10:
      profiler = _start_profile(run.device)
    if profiler is not None and step == run.init_step + 20:
      _stop_profile(profiler, args.profile_dir, step)
      profiler = None

    with time_tracker.record_time('train_step'):
      generator = training.step_generator(run.exp_config.random_seed, step,
                                          run.device)
      state, stats = train_step(generator, state, batch, scalar_params)
      host_stats = None
      if step % train_config.print_every == 0:
        host_stats = _to_host(stats)  # sync for honest timing
      time_tracker.toc('total')

    if host_stats is not None:
      log.info('step=%d, warp_alpha=%.04f, time_alpha=%.04f, %s', step,
               state.warp_alpha, state.time_alpha,
               time_tracker.summary_str('last'))
      for branch in ('coarse', 'fine'):
        if branch in host_stats:
          metrics_str = ', '.join(f'{k}={v:.04f}'
                                  for k, v in host_stats[branch].items())
          log.info('\t%s metrics: %s', branch, metrics_str)

    if step % train_config.save_every == 0:
      save(state)

    if step % train_config.log_every == 0:
      if host_stats is None:
        host_stats = _to_host(stats)
      _log_to_tensorboard(summary_writer, state, scalar_params, host_stats,
                          time_dict=time_tracker.summary('mean'))
      time_tracker.reset()

    if step % train_config.histogram_every == 0:
      _log_histograms(summary_writer, run.model, state)

    time_tracker.tic('data', 'total')

  if profiler is not None:
    _stop_profile(profiler, args.profile_dir, step + 1)
  if step >= run.init_step and step % train_config.save_every != 0:
    save(state)
  if summary_writer:
    summary_writer.close()
  if step >= run.init_step and host_stats is None:
    host_stats = _to_host(stats)
  collectives = mesh.collective_stats()
  if collectives['calls']:
    log.info('all-reduce over %d ranks: %d calls, %d bytes and %.3f ms a '
             'step', mesh.world_size(), collectives['calls'],
             collectives['bytes'] // collectives['calls'],
             collectives['ms'] / collectives['calls'])
  return Result(run, state, host_stats, time_tracker, save_seconds,
                collectives)


def _start_profile(device):
  activities = [torch.profiler.ProfilerActivity.CPU]
  if device.type == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  profiler = torch.profiler.profile(activities=activities)
  profiler.start()
  return profiler


def _stop_profile(profiler, profile_dir, step):
  profiler.stop()
  os.makedirs(profile_dir, exist_ok=True)
  rank = f'_rank{mesh.rank()}' if mesh.world_size() > 1 else ''
  path = os.path.join(profile_dir, f'trace_to_step_{step}{rank}.json')
  profiler.export_chrome_trace(path)
  log.info('Wrote a torch.profiler trace to %s', path)


def main(argv: Optional[Sequence[str]] = None) -> Result:
  args = parse_args(argv)
  if not logging.getLogger().handlers:
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
  return train(setup(args), args)


if __name__ == '__main__':
  main()
  mesh.shutdown()
