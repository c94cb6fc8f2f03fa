#!/usr/bin/env python3
"""The JAX package's training over several seeds, on the CPU, on the
workload of scripts/training_spread_torch.py.

The workload (scene, model, batch, schedules, evals) is read from that
script's module, so the two packages train the same thing: the plain
float32 route (`model.apply`) of the narrowed bench model on the quality
bench's scene at 96x72, to step 3,000 of a 10,000-step schedule. One JSON
curve per seed, beside the port's:

  JAX_PLATFORMS=cpu python3 scripts/training_spread_jax.py --seeds 0 1 2 3 \\
      --out_dir nerfies_tpu_torch/curves/spread

Seed s initialises from PRNGKey(2s), draws the steps from
fold_in(PRNGKey(2s + 1), step) (seed 0: scripts/quality_bench.py's keys)
and shuffles the rays and the background points with s.

  --save_init PATH   writes each seed's init params ('/'-joined names;
                     '{seed}' in PATH becomes the seed) for
                     training_spread_torch.py --init_npz;
  --save_state PATH  trains the narrower model of STATE_MODEL_FIELDS and
                     writes, at its last eval, the params, both Adam
                     moments and their count, the warp alpha, and the next
                     batch's first rays and background points, with the
                     scene's ids and bounds (tests/data/trained_state.npz,
                     which tests/test_torch_training.py loads on both
                     sides).
"""

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

import flax.linen as nn
from flax import traverse_util
import jax
import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
# Run as a script, its own folder leads sys.path, and scripts/profile.py
# there would shadow the standard library's `profile`.
sys.path[:] = [str(REPO)] + [
    p for p in sys.path if pathlib.Path(p or '.').resolve() != REPO / 'scripts']


def _workload():
  spec = importlib.util.spec_from_file_location(
      'training_spread_torch', REPO / 'scripts' / 'training_spread_torch.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


W = _workload()


def jax_model_config(fields):
  """nerfies_tpu.configs.ModelConfig with the fields of the port's
  config of the workload (activations by name become flax's)."""
  from nerfies_tpu import configs
  values = dataclasses.asdict(W.model_config(fields))
  for key in ('activation', 'sigma_activation'):
    values[key] = getattr(nn, values[key])
  return configs.ModelConfig(**values)


def flat_numpy(tree, prefix=''):
  return {prefix + k: np.asarray(v) for k, v in traverse_util.flatten_dict(
      jax.device_get(tree), sep='/').items()}


def run(seed, scene_dir, out_path=None, stop_at=W.STOP_AT,
        eval_every=W.EVAL_EVERY, fields=None, save_init='', save_state=''):
  """Trains one seed; returns the curve (and writes it to `out_path`)."""
  from nerfies_tpu import configs
  from nerfies_tpu import datasets
  from nerfies_tpu import evaluation
  from nerfies_tpu import schedules
  from nerfies_tpu import training
  from nerfies_tpu.datasets import core as datasets_core
  from nerfies_tpu.datasets import synthetic
  from nerfies_tpu.models import nerf
  from nerfies_tpu.parallel import mesh as mesh_lib

  scene = pathlib.Path(scene_dir)
  if not (scene / 'dataset.json').exists():
    synthetic.write_synthetic_dataset(scene, **W.SCENE)
  datasource = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(scene)}, image_scale=1,
      use_appearance_id=True, use_camera_id=True, use_warp_id=True,
      random_seed=seed)
  fields = fields or W.MODEL_FIELDS
  config = jax_model_config(fields)
  ids = dict(appearance_ids=datasource.appearance_ids,
             camera_ids=datasource.camera_ids,
             warp_ids=datasource.warp_ids,
             near=datasource.near, far=datasource.far)
  train_config = configs.TrainConfig(
      batch_size=W.BATCH_SIZE, use_elastic_loss=True,
      elastic_reduce_method='weight', elastic_loss_type='log_svals',
      use_background_loss=True)
  model, params = nerf.construct_nerf(
      jax.random.PRNGKey(W.params_seed(seed)), config,
      batch_size=W.BATCH_SIZE, use_warp_jacobian=True, use_weights=True,
      **ids)
  if save_init:
    path = pathlib.Path(save_init.format(seed=seed))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat_numpy(params))
  mesh = mesh_lib.create_mesh()
  step_fn = training.compile_train_step(model, train_config, mesh)
  state = jax.device_put(training.create_train_state(params),
                         mesh_lib.replicated_sharding(mesh))

  lr_sched = schedules.from_config(W.LR_SCHEDULE)
  warp_alpha_sched = schedules.from_config(
      W.warp_alpha_schedule(config.num_warp_freqs))
  train_iter = datasource.create_iterator(
      datasource.train_ids, flatten=True, shuffle=True,
      batch_size=W.BATCH_SIZE, prefetch_size=3)
  points = datasource.load_points(shuffle=True)
  points_iter = datasets_core.iterator_from_arrays(
      points, batch_size=min(len(points), W.BACKGROUND_POINTS),
      shuffle=True, seed=seed, prefetch_size=3)

  eval_model, _ = nerf.construct_nerf(
      jax.random.PRNGKey(0),
      dataclasses.replace(config, use_stratified_sampling=False),
      batch_size=W.EVAL_CHUNK, **ids)
  render_fn = evaluation.make_render_fn(eval_model, mesh, fast='off')

  def view(item_id):
    item = next(iter(datasource.create_iterator([item_id], batch_size=0,
                                                repeat=False)))
    return ({k: item[k] for k in ('origins', 'directions', 'metadata')},
            item['rgb'])

  def psnr(out, rgb):
    pred = np.clip(np.asarray(out['rgb']), 0, 1)
    return float(-10.0 * np.log10(np.mean((pred - rgb) ** 2)))

  val_rays, val_rgb = view(datasource.val_ids[0])
  train_rays, train_rgb = view(datasource.train_ids[0])
  result = {
      'package': 'nerfies_tpu',
      'route': 'plain float32',
      'seed': seed,
      'device': jax.devices()[0].device_kind,
      'image_size': list(W.SCENE['image_size']),
      'batch_size': W.BATCH_SIZE,
      'steps': W.SCHEDULE_STEPS,
      'curve': [],
  }
  if stop_at < W.SCHEDULE_STEPS:
    result['partial'] = True

  rng = jax.random.PRNGKey(W.step_seed(seed))
  losses = []
  t_start = time.time()
  for step in range(1, stop_at + 1):
    batch = next(train_iter)
    batch['background_points'] = next(points_iter)
    scalar_params = training.ScalarParams(
        learning_rate=lr_sched(step), elastic_loss_weight=W.ELASTIC_WEIGHT,
        background_loss_weight=W.BACKGROUND_WEIGHT)
    state = state.replace(warp_alpha=jax.numpy.asarray(
        warp_alpha_sched(step), jax.numpy.float32))
    state, stats, _ = step_fn(jax.random.fold_in(rng, step), state, batch,
                              scalar_params)
    losses.append(float(jax.device_get(stats['fine']['loss/rgb'])))
    if step % eval_every == 0 or step == stop_at:
      if not np.isfinite(losses[-1]):
        raise FloatingPointError(f'step {step}: loss {losses[-1]}')
      val = evaluation.render_image(state, val_rays, render_fn,
                                    chunk=W.EVAL_CHUNK)
      train_view = evaluation.render_image(state, train_rays, render_fn,
                                           chunk=W.EVAL_CHUNK)
      result['curve'].append({
          'step': step,
          'val_psnr': psnr(val, val_rgb),
          'train_view_psnr': psnr(train_view, train_rgb),
          'train_loss': losses[-1],
          'train_loss_mean': float(np.mean(losses)),
          'warp_alpha': float(warp_alpha_sched(step)),
          'wall_s': time.time() - t_start})
      losses = []
      print(json.dumps(result['curve'][-1]), flush=True)
      if out_path:
        W.write_curve(out_path, result)
  if save_state:
    _save_state(save_state, state, next(train_iter), next(points_iter),
                ids)
  return result


def _save_state(path, state, batch, points, ids):
  """The state and the next batch's first rays and points, as the test
  reads them back."""
  state = jax.device_get(state)
  arrays = {**flat_numpy(state.params, 'params/'),
            **flat_numpy(state.opt_state.mu, 'mu/'),
            **flat_numpy(state.opt_state.nu, 'nu/'),
            'count': np.asarray(state.opt_state.count),
            'step': np.asarray(state.step),
            'warp_alpha': np.asarray(state.warp_alpha, np.float32)}
  rays = jax.tree.map(lambda a: np.asarray(a)[:W.STATE_BATCH_RAYS], batch)
  arrays.update(flat_numpy(rays, 'batch/'))
  arrays['batch/background_points'] = np.asarray(
      points)[:W.STATE_BATCH_POINTS]
  for key in ('appearance_ids', 'camera_ids', 'warp_ids'):
    arrays[f'ids/{key}'] = np.asarray(ids[key])
  arrays['ids/near'] = np.asarray(ids['near'], np.float32)
  arrays['ids/far'] = np.asarray(ids['far'], np.float32)
  pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
  np.savez_compressed(path, **arrays)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seeds', type=int, nargs='+', default=[0])
  parser.add_argument('--scene_dir', default=W.SCENE_DIR)
  parser.add_argument('--out_dir', default='nerfies_tpu_torch/curves/spread')
  parser.add_argument('--stop_at', type=int, default=W.STOP_AT)
  parser.add_argument('--eval_every', type=int, default=W.EVAL_EVERY)
  parser.add_argument('--save_init', default='',
                      help="write each seed's init params here ('{seed}' in "
                      "the path becomes the seed); --stop_at 0 writes them "
                      "alone")
  parser.add_argument('--save_state', default='',
                      help='train the narrower state model and write its '
                      'state here')
  args = parser.parse_args(argv)
  jax.config.update('jax_platforms', 'cpu')
  out_dir = pathlib.Path(args.out_dir)
  for seed in args.seeds:
    tag = '_state' if args.save_state else ''
    name = W.curve_name('jax', 'cpu', seed, tag)
    run(seed, args.scene_dir, out_dir / name, stop_at=args.stop_at,
        eval_every=args.eval_every,
        fields=W.STATE_MODEL_FIELDS if args.save_state else None,
        save_init=args.save_init, save_state=args.save_state)
    print(f'wrote {out_dir / name}', flush=True)


if __name__ == '__main__':
  main()
