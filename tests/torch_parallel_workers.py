"""The port's data-parallel paths at 1 rank and in a 2-rank gloo group.

`run_all(inputs, out_dir)` runs every case of tests/test_torch_parallel.py
in this process: at world size 1 without a group, or as one rank of a
group that `spawn` starts with torch.multiprocessing (gloo on the CPU,
a file:// store under the test's tmp dir, so no port is fixed). Each
case's outputs, or the exception it raised, land in
`out_dir/world{N}_rank{r}.pt`. Imports no JAX: the spawned ranks import only this
module, torch and the port.
"""

import os
import traceback
from unittest import mock

import torch

from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import occupancy
from nerfies_tpu_torch import train
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import core
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.parallel import mesh


def _model(case, params=None):
  """The case's NerfModel on the CPU, its params from the seed or given."""
  model, own = nerf.construct_nerf(
      configs.ModelConfig(**case['config']), **case['ids'],
      generator=torch.Generator().manual_seed(case.get('seed', 0)),
      device='cpu', use_warp_jacobian=case.get('use_warp_jacobian', True),
      use_weights=case.get('use_weights', True))
  return model, params if params is not None else own


def _rows(tree):
  """This rank's contiguous rows of every array of a global batch."""
  if isinstance(tree, dict):
    return {k: _rows(v) for k, v in tree.items()}
  return tree[mesh.local_batch_slice(len(tree))]


def _flat(tree):
  return {'/'.join(p): t.detach().clone()
          for p, t in fused_mlp.flatten_tree(tree)}


def _step(case, model, batch):
  return training.make_train_step(
      model, configs.TrainConfig(batch_size=len(batch['origins']),
                                 **case['switches']), device='cpu')


def train_case(case, ckpt_dir):
  """Steps from the seed's params over one global batch a step; then the
  same steps again, saved after the second and resumed from the
  checkpoint; the number of torch.save calls this rank made."""
  model, params = _model(case)
  step = _step(case, model, case['batches'][0])
  scalars = training.ScalarParams(**case['scalars'])
  state = training.create_train_state(params, warp_alpha=case['warp_alpha'])
  out = {'stats': [], 'params': []}
  for i, batch in enumerate(case['batches']):
    state, stats = step(training.step_generator(7, i, 'cpu'), state,
                        _rows(batch), scalars)
    out['stats'].append(_flat(stats))
  out['params'] = _flat(state.params)

  saves = []
  real_save = torch.save
  state = training.create_train_state(params, warp_alpha=case['warp_alpha'])
  for i, batch in enumerate(case['batches']):
    if i == len(case['batches']) - 1:
      with mock.patch.object(checkpoints.torch, 'save',
                             lambda *a, **k: saves.append(1) or real_save(
                                 *a, **k)):
        checkpoints.save_checkpoint(ckpt_dir, state)
      fresh = training.create_train_state(_model(case)[1])
      state = checkpoints.restore_checkpoint(ckpt_dir, fresh)
    state, _ = step(training.step_generator(7, i, 'cpu'), state,
                    _rows(batch), scalars)
  out['resumed_params'] = _flat(state.params)
  out['saves'] = len(saves)
  return out


def jax_step_case(case):
  """One step from given params, with the background draws given: this
  rank's rows of the global batch and of the draws."""
  model, params = _model(case, case['params'])
  model.use_fused_warp = case.get('use_fused_warp', True)
  state = training.create_train_state(params, warp_alpha=case['warp_alpha'])
  ids, noise = case['draws']
  new_state, stats = _step(case, model, case['batch'])(
      None, state, _rows(case['batch']),
      training.ScalarParams(**case['scalars']), (_rows(ids), _rows(noise)))
  return {'stats': _flat(stats), 'mu': _flat(new_state.opt_state.mu)}


def iterator_case(case):
  """The first batches of iterator_from_pool, its rank and world size
  left to the group."""
  pool = core.RayPool(**case['pool'])
  it = core.iterator_from_pool(pool, case['batch_size'], seed=3,
                               prefetch_size=0)
  return [next(it) for _ in range(case['num_batches'])]


def render_case(case):
  """render_image and render_camera of a deterministic model (the
  serving path) and of a stratified one (the plain forward, its draws
  sliced by rank); the ValueError of an indivisible chunk."""
  out = {}
  for name, fast in (('serve', 'auto'), ('stratified', 'off')):
    config = dict(case['config'],
                  use_stratified_sampling=name == 'stratified')
    model, params = _model(dict(case, config=config), None)
    fn = evaluation.make_render_fn(model, device='cpu', fast=fast)
    state = evaluation.RenderState(params, warp_alpha=case['warp_alpha'])
    image = evaluation.render_image(state, case['rays'], fn,
                                    chunk=case['chunk'], seed=5)
    camera = evaluation.render_camera(state, case['camera'],
                                      case['metadata_ids'], fn,
                                      chunk=case['chunk'], seed=5)
    for key in ('rgb', 'depth', 'med_depth', 'acc'):
      out[f'{name}/image/{key}'] = image[key]
      out[f'{name}/camera/{key}'] = camera[key]
  try:
    evaluation.render_image(state, case['rays'], fn, chunk=case['chunk'] + 1,
                            device_multiple=1)
    out['indivisible'] = None
  except ValueError as e:
    out['indivisible'] = str(e)
  return out


def occupancy_case(case):
  """The occupied voxels of a bake, and every rank's as gathered."""
  model, params = _model(case)
  grid = occupancy.build_grid(
      occupancy.sigma_fn_from_params(params, model), bbox_min=[-1, -1, -1],
      bbox_max=[1, 1, 1], resolution=case['resolution'],
      sigma_threshold=case['threshold'], chunk=1000, device='cpu')
  mine = grid.occupied.reshape(1, -1)
  return {'occupied': mine[0],
          'every_rank': mesh.all_gather_rows(mine.to(torch.uint8))}


def batch_size_case(case):
  """train.setup with a batch size that the world size does not divide."""
  try:
    train.setup(train.parse_args(case['argv']))
    return None
  except ValueError as e:
    return str(e)


CASES = {
    'train': lambda case, tmp: train_case(case, os.path.join(tmp, 'ckpt')),
    'jax_plain': lambda case, tmp: jax_step_case(case),
    'jax_fused': lambda case, tmp: jax_step_case(case),
    'iterator': lambda case, tmp: iterator_case(case),
    'render': lambda case, tmp: render_case(case),
    'occupancy': lambda case, tmp: occupancy_case(case),
    'batch_size': lambda case, tmp: batch_size_case(case),
}


def run_all(inputs, out_dir):
  """Every case of `inputs` ({name: case}) in turn; returns and saves
  {name: ('ok', outputs) or ('error', traceback)}."""
  tmp = os.path.join(out_dir, f'work{mesh.world_size()}')
  results = {}
  for name, case in inputs.items():
    try:
      results[name] = ('ok', CASES[name](case, tmp))
    except Exception:  # reported to the test that reads this case
      results[name] = ('error', traceback.format_exc())
  torch.save(results, os.path.join(
      out_dir, f'world{mesh.world_size()}_rank{mesh.rank()}.pt'))
  return results


def _rank_main(rank, world, store, inputs_path, out_dir):
  torch.set_num_threads(1)
  mesh.init('cpu', init_method=f'file://{store}', rank=rank,
            world_size=world)
  try:
    run_all(torch.load(inputs_path, weights_only=False), out_dir)
  finally:
    mesh.shutdown()


def spawn(inputs, out_dir, world=2):
  """`run_all` on `world` gloo ranks; returns each rank's results."""
  inputs_path = os.path.join(out_dir, 'inputs.pt')
  torch.save(inputs, inputs_path)
  torch.multiprocessing.spawn(
      _rank_main,
      args=(world, os.path.join(out_dir, 'store'), inputs_path, out_dir),
      nprocs=world, join=True)
  return [torch.load(os.path.join(out_dir, f'world{world}_rank{r}.pt'),
                     weights_only=False) for r in range(world)]
