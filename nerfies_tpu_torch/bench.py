"""Training and render throughput of the bench workload on the card.

The port's counterpart of bench.py, with its workloads, flags and one
JSON line:

  python -m nerfies_tpu_torch.bench
  torchrun --standalone --nproc_per_node=4 -m nerfies_tpu_torch.bench

It measures:
  1. Sustained train-step throughput (rays/s a card), compute only: the
     bench training workload (batch 6144 rays, 128 coarse + 128 fine
     samples a ray, SE(3) warp, elastic and background losses, bf16)
     through `training.make_train_step`, one host batch a step, timed
     between two synchronisations. Baseline: the reference's "14 h on 8
     GPUs", 6144 * 250k steps / 14 h / 8 ~= 3810 rays/s a GPU.
  2. The same steps fed from an on-disk synthetic scene through the ray
     pool and the prefetching iterators (slicing, collation and the copy
     to the card included).
  3. Model FLOPs: JAX's XLA count of the same step, read from the
     committed `.flops_cache.json`, times steps/s over the card's dense
     bf16 peak (PEAK_BF16_FLOPS).
  4. Full-image render throughput (rays/s a card) through
     `evaluation.render_image` over a sweep of ray chunks, then
     `evaluation.render_camera` (rays made on the card) at the best
     chunk, and the projected 1080p frame seconds.

Prints ONE JSON line, last: `metric`/`value`/`unit`/`vs_baseline`
describe the train throughput, the other measurements ride as extra
keys. Lines before it start with '#'.

Under `torchrun` (parallel/mesh.py) each rank steps its rows of every
global batch and renders its rows of every chunk; the per-card numbers
divide rank 0's wall-clock rates by the world size, and rank 0 alone
prints. Each rank writes its own copy of the on-disk scene. The batch
size must divide by the world size.

Runs on the card unless `--device cpu` is given (the kernels' plain
versions); without a card the default raises. Left out of bench.py's
flags: `--emit_flops`, which lowers JAX's step on XLA to count its
FLOPs; the port has no XLA and reads the count that lowering wrote.
"""

import argparse
import dataclasses
import json
import pathlib
import shutil
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.parallel import mesh

BASELINE_RAYS_PER_SEC_PER_GPU = 6144 * 250_000 / (14 * 3600) / 8  # ~3810

# Dense bf16 tensor FLOP/s of a card at its full power limit, from
# NVIDIA's data sheets, keyed by torch.cuda.get_device_name(). Looked up
# by the whole name: the PCIe and NVL parts have lower peaks than the SXM
# part whose name they share a prefix with.
PEAK_BF16_FLOPS = {
    'NVIDIA H100 80GB HBM3': 989e12,
    'NVIDIA H100 PCIe': 756e12,
    'NVIDIA H100 NVL': 835e12,
}

# JAX's XLA model-FLOPs of one train step, by batch size (bench.py's
# step_flops writes it).
FLOPS_CACHE = (pathlib.Path(__file__).resolve().parents[1]
               / '.flops_cache.json')

HD_PIXELS = 1920 * 1080


def model_config(use_bfloat16: bool = True,
                 use_stratified_sampling: bool = True,
                 use_fused_mlp: bool = False,
                 use_fused_warp: bool = True) -> configs.ModelConfig:
  """bench.py's model: configs.bench_render_config with its switches."""
  return dataclasses.replace(
      configs.bench_render_config(), use_bfloat16=use_bfloat16,
      use_stratified_sampling=use_stratified_sampling,
      use_fused_mlp=use_fused_mlp, use_fused_warp=use_fused_warp)


def build_workload(batch_size: int, use_bfloat16: bool = True,
                   use_fused_mlp: bool = False, use_fused_warp: bool = True,
                   device='cuda',
                   config: Optional[configs.ModelConfig] = None):
  """(model, params, train config) of bench.py's training workload: the
  model of model_config(...) (or `config`, which a test narrows) with
  the bench ids, seed 0, and the dense Jacobians and weights its elastic
  loss reads."""
  if config is None:
    config = model_config(use_bfloat16, use_fused_mlp=use_fused_mlp,
                          use_fused_warp=use_fused_warp)
  _, train_config = configs.bench_train_config()
  model, params = nerf.construct_nerf(
      config, **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(0), device=device,
      use_warp_jacobian=True, use_weights=True)
  return model, params, dataclasses.replace(train_config,
                                            batch_size=batch_size)


def fake_batch(batch_size: int, bg_points: int = 16384, seed: int = 0,
               id_counts=(16, 2, 16)) -> Dict[str, object]:
  """bench.py's fake_batch: unit directions, random colours, ids below
  `id_counts` (warp, camera, appearance; bench.py's by default), zero
  times and normal background points. The ids are int64, the port's id
  type, where bench.py casts them to uint32."""
  rng = np.random.RandomState(seed)
  directions = rng.randn(batch_size, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  ids = lambda high: rng.randint(0, high, (batch_size, 1)).astype(np.int64)
  warp, camera, appearance = id_counts
  return {
      'origins': np.zeros((batch_size, 3), np.float32),
      'directions': directions,
      'rgb': rng.uniform(size=(batch_size, 3)).astype(np.float32),
      'metadata': {
          'warp': ids(warp),
          'camera': ids(camera),
          'appearance': ids(appearance),
          'time': np.zeros((batch_size, 1), np.float32),
      },
      'background_points': rng.randn(bg_points, 3).astype(np.float32),
  }


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _say(line: str) -> None:
  if mesh.is_main():
    print(line, flush=True)


def bench_train_compute(args, step, state, scalars, device):
  """Compute only: pre-built host batches, one a step, no input pipeline.

  Returns (steps/s of the timed steps, the state after them).
  """
  batches = [mesh.rank_rows(fake_batch(args.batch_size, seed=i))
             for i in range(args.warmup_steps + args.bench_steps)]
  for i in range(args.warmup_steps):
    state, _ = step(training.step_generator(0, i, device), state, batches[i],
                    scalars)
  _sync(device)
  start = time.perf_counter()
  for i in range(args.warmup_steps, args.warmup_steps + args.bench_steps):
    state, _ = step(training.step_generator(0, i, device), state, batches[i],
                    scalars)
  _sync(device)
  return args.bench_steps / (time.perf_counter() - start), state


def bench_train_e2e(args, step, state, scalars, device) -> float:
  """Steps fed from an on-disk scene through the ray pool iterator;
  returns steps/s of the timed steps."""
  tmp = tempfile.mkdtemp(prefix='bench_scene_')
  try:
    synthetic.write_synthetic_dataset(
        tmp, num_train=8, num_val=1, image_size=(256, 192),
        motion_amplitude=0.05, num_points=16384)
    datasource = datasets.from_config(
        {'type': 'nerfies', 'data_dir': tmp},
        image_scale=1, use_appearance_id=True, use_camera_id=True,
        use_warp_id=True, random_seed=0)
    # This rank's rows of each global batch.
    train_iter = datasource.create_iterator(
        datasource.train_ids, flatten=True, shuffle=True,
        batch_size=args.batch_size, prefetch_size=3)
    points = datasource.load_points(shuffle=True)
    points_batch_size = min(len(points), 16384)
    points_batch_size -= points_batch_size % mesh.world_size()
    rows = mesh.local_batch_slice(points_batch_size)
    points_iter = datasets.iterator_from_arrays(
        points, batch_size=points_batch_size, shuffle=True, seed=0,
        prefetch_size=3)

    def run(n, state):
      for i in range(n):
        batch = next(train_iter)
        batch['background_points'] = next(points_iter)[rows]
        state, _ = step(training.step_generator(1, i, device), state, batch,
                        scalars)
      _sync(device)
      return state

    state = run(args.warmup_steps, state)
    start = time.perf_counter()
    run(args.bench_steps, state)
    return args.bench_steps / (time.perf_counter() - start)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


def step_flops(batch_size: int) -> Optional[float]:
  """JAX's XLA model-FLOPs of one train step at `batch_size`, from the
  committed .flops_cache.json (read only); None where it has no count."""
  try:
    cache = json.loads(FLOPS_CACHE.read_text())
  except (OSError, ValueError):
    return None
  return cache.get(str(batch_size))


def mfu_keys(flops: Optional[float], steps_per_sec: float, n_chips: int,
             device_kind: str) -> Dict[str, float]:
  """bench.py's model-FLOPs keys; none without a count, no mfu_pct for a
  card of unknown peak."""
  if not flops:
    return {}
  keys = {'train_step_model_tflops': round(flops / 1e12, 3),
          'model_tflops_per_sec_per_chip': round(
              flops * steps_per_sec / n_chips / 1e12, 2)}
  peak = PEAK_BF16_FLOPS.get(device_kind)
  if peak:
    keys['mfu_pct'] = round(100.0 * flops * steps_per_sec / n_chips / peak, 2)
  return keys


def bench_render(args, config, device):
  """Full-image render throughput of `config` (deterministic samples).

  Sweeps the ray chunk with `--render_reps` timed renders a chunk after
  one warm render, keeps the best, then renders an orbit camera with its
  rays made on the card at the best chunk. A chunk that runs out of
  device memory is recorded with its error, as bench.py records a chunk
  that does not compile; any other failure ends the run.

  Returns (best sweep rays/s, best chunk, {chunk: rays/s},
  render_camera rays/s, {chunk: error}).
  """
  model, params = nerf.construct_nerf(
      config, **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(0), device=device)
  state = evaluation.RenderState(params, warp_alpha=configs.BENCH_WARP_ALPHA)
  h = w = args.render_size
  rng = np.random.RandomState(0)
  d = rng.randn(h, w, 3).astype(np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  ids = np.zeros((h, w, 1), np.int64)
  rays = {
      'origins': np.zeros((h, w, 3), np.float32),
      'directions': d,
      'metadata': {'warp': ids, 'camera': ids, 'appearance': ids,
                   'time': np.zeros((h, w, 1), np.float32)},
  }
  render_fn = evaluation.make_render_fn(model, device=device)
  sweep, sweep_errors = {}, {}
  for chunk in args.render_chunks:
    try:
      evaluation.render_image(state, rays, render_fn, chunk=chunk)  # warm
      reps = [evaluation.render_image(state, rays, render_fn,
                                      chunk=chunk)['rays_per_sec']
              for _ in range(args.render_reps)]
    except torch.cuda.OutOfMemoryError as e:
      sweep[chunk] = 0.0
      first_line = str(e).strip().splitlines()[0] if str(e) else ''
      sweep_errors[chunk] = f'{type(e).__name__}: {first_line[:160]}'
      _say(f'# chunk {chunk} failed: {sweep_errors[chunk]}')
      torch.cuda.empty_cache()
      continue
    sweep[chunk] = max(reps)
    _say(f'# render {h}x{w} chunk {chunk}: best of {len(reps)} '
         f'{sweep[chunk]:.1f} rays/s')
  best_chunk = max(sweep, key=sweep.get)

  camera_rps = 0.0
  if sweep[best_chunk] > 0.0:
    camera = synthetic.make_orbit_camera(0.3, image_size=(w, h))
    metadata_ids = {'warp': 0, 'camera': 0, 'appearance': 0, 'time': 0.0}
    evaluation.render_camera(state, camera, metadata_ids, render_fn,
                             chunk=best_chunk)  # warm
    camera_rps = evaluation.render_camera(
        state, camera, metadata_ids, render_fn,
        chunk=best_chunk)['rays_per_sec']
  return sweep[best_chunk], best_chunk, sweep, camera_rps, sweep_errors


def run(args: argparse.Namespace,
        config: Optional[configs.ModelConfig] = None) -> Dict:
  """Runs the benches on args.device (this rank's card under `torchrun`);
  prints the result as one JSON line on rank 0 and returns it.

  config: the training workload's model, by default model_config() under
  the flags (build_workload); a test narrows it. The render model is
  that model with deterministic samples and model_config()'s fused
  switches, as bench.py renders model_config(use_stratified_sampling=
  False).

  Raises:
    RuntimeError: for a CUDA device without a card.
    ValueError: a batch size that the world size does not divide.
  """
  device = mesh.init(args.device)
  n_chips = mesh.world_size()
  if args.batch_size % n_chips:
    raise ValueError('Batch size must be divisible by the number of devices.')
  device_kind = (torch.cuda.get_device_name(device)
                 if device.type == 'cuda' else device.type)
  card = quality_bench.card_label() if device.type == 'cuda' else None
  model, params, train_config = build_workload(
      args.batch_size, use_fused_mlp=args.fused,
      use_fused_warp=args.fused_warp, device=device, config=config)
  step = training.make_train_step(model, train_config, device)
  state = training.create_train_state(params,
                                      warp_alpha=configs.BENCH_WARP_ALPHA)
  scalars = training.ScalarParams(**configs.BENCH_TRAIN_SCALARS)
  _say(f'# {", ".join(card) if card else device_kind}: batch '
       f'{args.batch_size} over {n_chips} rank(s) on {device}, '
       f'{"fused" if model.fused_route else "plain"} route')

  flops = step_flops(args.batch_size)
  if device.type == 'cuda':
    torch.cuda.reset_peak_memory_stats(device)
  steps_per_sec, state = bench_train_compute(args, step, state, scalars,
                                             device)
  rays_per_sec_per_chip = steps_per_sec * args.batch_size / n_chips
  _say(f'# train: {args.bench_steps} steps after {args.warmup_steps} in '
       f'{args.bench_steps / steps_per_sec:.3f} s, '
       f'{1e3 / steps_per_sec:.2f} ms a step'
       + (f'; max_memory_allocated '
          f'{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB'
          if device.type == 'cuda' else ''))

  result = {
      'metric': 'train_rays_per_sec_per_chip',
      'value': round(rays_per_sec_per_chip, 1),
      'unit': 'rays/s',
      'vs_baseline': round(
          rays_per_sec_per_chip / BASELINE_RAYS_PER_SEC_PER_GPU, 3),
      'device_kind': device_kind,
      'num_chips': n_chips,
      **mfu_keys(flops, steps_per_sec, n_chips, device_kind),
  }

  if not args.skip_data:
    e2e_steps_per_sec = bench_train_e2e(args, step, state, scalars, device)
    result['train_e2e_rays_per_sec_per_chip'] = round(
        e2e_steps_per_sec * args.batch_size / n_chips, 1)

  if not args.skip_render:
    render_config = dataclasses.replace(
        config or model_config(), use_stratified_sampling=False,
        use_fused_mlp=False, use_fused_warp=True)
    sweep_rps, best_chunk, sweep, camera_rps, sweep_errors = bench_render(
        args, render_config, device)
    # The headline render number is the better of the two serving paths;
    # render_headline_path says which.
    render_rays_per_sec = max(sweep_rps, camera_rps)
    result['render_rays_per_sec_per_chip'] = round(
        render_rays_per_sec / n_chips, 1)
    result['render_headline_path'] = (
        'render_camera' if camera_rps > sweep_rps else 'host_rays_sweep')
    result['render_best_chunk'] = best_chunk
    result['render_chunk_sweep'] = {
        str(k): round(v / n_chips, 1) for k, v in sweep.items()}
    result['render_camera_rays_per_sec_per_chip'] = round(
        camera_rps / n_chips, 1)
    if sweep_errors:
      result['render_chunk_errors'] = {
          str(k): v for k, v in sweep_errors.items()}
    if render_rays_per_sec > 0.0:
      result['projected_1080p_frame_seconds_per_chip'] = round(
          HD_PIXELS / (render_rays_per_sec / n_chips), 2)

  # The kernels this process launched (none on the CPU), by wrapper.
  _say(f'# kernel launches: {json.dumps(fused_mlp.launch_counts())}')
  _say(json.dumps(result))
  return result


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--batch_size', type=int, default=6144)
  parser.add_argument('--warmup_steps', type=int, default=3)
  parser.add_argument('--bench_steps', type=int, default=20)
  # 512x512 = 262144 rays divides evenly by every swept chunk size, so
  # the sweep measures the render rather than padding.
  parser.add_argument('--render_size', type=int, default=512)
  parser.add_argument('--render_chunks', type=int, nargs='+',
                      default=[8192, 16384, 32768, 65536],
                      help='render chunk sizes to sweep; the best one is '
                           'reported as the headline render number')
  parser.add_argument('--render_reps', type=int, default=4,
                      help='timed repetitions per chunk; the best is kept')
  parser.add_argument('--skip_data', action='store_true')
  parser.add_argument('--skip_render', action='store_true')
  parser.add_argument('--fused', action=argparse.BooleanOptionalAction,
                      default=True,
                      help='train through the fused kernels\' route '
                           '(use_fused_mlp), as configs/tpu_*.gin do; '
                           '--no-fused takes the plain forward')
  parser.add_argument('--fused_warp', action=argparse.BooleanOptionalAction,
                      default=True,
                      help='with --fused: the warp field through its fused '
                           'kernels; --no-fused_warp keeps the plain warp '
                           'while the NeRF MLPs stay fused')
  parser.add_argument('--device', default='cuda',
                      help="torch device; 'cpu' runs the plain versions.")
  return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
  return run(parse_args(argv))


if __name__ == '__main__':
  main()
  mesh.shutdown()
