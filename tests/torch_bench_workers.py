"""The benches as ranks of a gloo group.

`spawn(inputs, out_dir, world, target)` starts `world` ranks with
torch.multiprocessing (gloo on the CPU, a file:// store under the test's
tmp dir); each runs `target(inputs)` and saves what it returns to
`out_dir/bench_rank{r}.pt`. `run_benches` runs `quality_bench.run`, then
`serve_bench.run` on the npz it saved, then `quality_bench.run` with a
batch the world size does not divide, and returns the results, its final
params and how many files of each kind it wrote. `run_bench` runs
`bench.run` and then with an indivisible batch, and returns what it
printed. Imports no JAX: the spawned ranks import only this module,
torch, numpy and the port.
"""

import contextlib
import io
import os
import pathlib
import traceback
from unittest import mock

import numpy as np
import torch

from nerfies_tpu_torch import bench
from nerfies_tpu_torch import checkpoints
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import serve_bench
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.parallel import mesh


def _counting(writes, kind, fn):
  def call(*args, **kwargs):
    writes[kind] = writes.get(kind, 0) + 1
    return fn(*args, **kwargs)
  return call


def run_benches(inputs):
  """The benches on this rank; the files it wrote, by kind."""
  writes = {}
  patches = [
      mock.patch.object(pathlib.Path, 'write_text',
                        _counting(writes, 'write_text',
                                  pathlib.Path.write_text)),
      mock.patch.object(np, 'savez', _counting(writes, 'savez', np.savez)),
      mock.patch.object(checkpoints, '_write',
                        _counting(writes, 'checkpoint', checkpoints._write)),
      mock.patch.object(synthetic, 'write_synthetic_dataset',
                        _counting(writes, 'scene',
                                  synthetic.write_synthetic_dataset)),
      mock.patch.object(serve_bench, 'HD_SIZE', inputs['hd_size']),
  ]
  for patch in patches:
    patch.start()
  try:
    quality = quality_bench.run(
        quality_bench.parse_args(inputs['quality_argv']), inputs['config'])
    serve = serve_bench.run(serve_bench.parse_args(inputs['serve_argv']),
                            inputs['config'])
  finally:
    for patch in patches:
      patch.stop()
  try:
    quality_bench.run(quality_bench.parse_args(inputs['odd_batch_argv']),
                      inputs['config'])
    odd_batch = None
  except ValueError as e:
    odd_batch = str(e)
  return {
      'curve': quality.result['curve'],
      'params': {'/'.join(p): t.detach().clone()
                 for p, t in fused_mlp.flatten_tree(quality.state.params)},
      'modes': serve.result['modes'],
      'grid': serve.result['grid'],
      'writes': writes,
      'odd_batch': odd_batch,
      'world_size': mesh.world_size(),
  }


def run_bench(inputs):
  """bench.run on this rank, then with inputs['odd_batch_argv']; what it
  printed, its result and the second run's error."""
  stdout = io.StringIO()
  with contextlib.redirect_stdout(stdout):
    result = bench.run(bench.parse_args(inputs['argv']), inputs['config'])
  try:
    bench.run(bench.parse_args(inputs['odd_batch_argv']), inputs['config'])
    odd_batch = None
  except ValueError as e:
    odd_batch = str(e)
  return {'stdout': stdout.getvalue(), 'result': result,
          'odd_batch': odd_batch, 'world_size': mesh.world_size()}


def _rank_main(rank, world, store, inputs_path, out_dir, target):
  torch.set_num_threads(1)
  mesh.init('cpu', init_method=f'file://{store}', rank=rank,
            world_size=world)
  try:
    out = ('ok', target(torch.load(inputs_path, weights_only=False)))
  except Exception:  # pylint: disable=broad-except
    out = ('error', traceback.format_exc())
  finally:
    mesh.shutdown()
  torch.save(out, os.path.join(out_dir, f'bench_rank{rank}.pt'))


def spawn(inputs, out_dir, world=2, target=run_benches):
  """`target` on `world` gloo ranks; returns each rank's results."""
  inputs_path = os.path.join(out_dir, 'bench_inputs.pt')
  torch.save(inputs, inputs_path)
  torch.multiprocessing.spawn(
      _rank_main,
      args=(world, os.path.join(out_dir, 'bench_store'), inputs_path,
            out_dir, target),
      nprocs=world, join=True)
  return [torch.load(os.path.join(out_dir, f'bench_rank{r}.pt'),
                     weights_only=False) for r in range(world)]
