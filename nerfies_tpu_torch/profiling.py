"""One profiling tool for the port: step / render / layout / dispatch / trace.

The counterpart of scripts/profile.py on torch.profiler:

  # The bench workload's train step (configs.bench_train_config): the
  # median and spread of unprofiled steps, then one profiled step with
  # device-busy ms, the idle share against that median, and device ms by
  # op for every op (the port's kernels by name, the rest by aten op):
  python -m nerfies_tpu_torch.profiling step --batch_size 6144 --steps 10
  python -m nerfies_tpu_torch.profiling step --elastic median --no-fused

  # Write the profiled step's trace (Chrome JSON), then summarise it:
  python -m nerfies_tpu_torch.profiling step --trace_dir /tmp/trace
  python -m nerfies_tpu_torch.profiling trace /tmp/trace/step.json

  # Render throughput, the posenc -> product layouts, launch overhead:
  python -m nerfies_tpu_torch.profiling render --render_size 384
  python -m nerfies_tpu_torch.profiling layout
  python -m nerfies_tpu_torch.profiling dispatch

  # Data-parallel: the step on every card, with the all-reduce's ms and
  # bytes a step (rank 0 prints):
  torchrun --standalone --nproc_per_node=4 -m nerfies_tpu_torch.profiling step

`step`, `render --trace_dir` and `trace` also charge every device op to
the program span (utils.span, one of SPANS) that launched it, with the
idle ms before it (`span_table` of the Chrome trace).

Every mode runs on the card unless `--device cpu` is given. Left out of
scripts/profile.py's flags: `--bwd_tile` (the CUDA kernels' tiles are
fixed when they are compiled; nothing reads a tile from the environment)
and the compile cache (PyTorch compiles no step; ops/_build.py keeps the
kernels' library). `xplane` becomes `trace`: torch.profiler writes Chrome
JSON, not an XLA xplane.
"""

import argparse
import collections
import dataclasses
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfies_tpu_torch import bench
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import training
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import encoding
from nerfies_tpu_torch.parallel import mesh

# Device kernels of the port (csrc/*.cu), named apart in every breakdown.
OUR_KERNEL_NAMES = ('nerf_mlp_kernel', 'warp_trunk_kernel',
                    'nerf_bwd_rows_kernel', 'warp_fwd_kernel',
                    'warp_bwd_rows_kernel', 'dw_partial_kernel',
                    'dw_reduce_kernel')
# Device kernels of a collective (NCCL's names).
COLLECTIVE_MARKS = ('nccl',)
# Chrome-trace categories of device work, and of its launches.
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATEGORIES = ('cuda_runtime', 'cuda_driver')
# The program's spans (utils.span), the only ranges of a trace that
# `span_table` charges, and its unit spans: the thread that opens those is
# the one whose span an op launched outside any span of its own thread (by
# the autograd engine's thread, in the backward) is charged to.
SPANS = ('data.wait', 'train.to_device', 'train.step', 'train.forward',
         'train.loss', 'train.backward', 'train.all_reduce', 'train.optimizer',
         'kernel.pack', 'render.frame', 'render.rays', 'render.model',
         'render.gather')
UNIT_SPANS = ('train.step', 'render.frame')
# As in scripts/profile.py: samples a ray in `layout`, and the calls each
# timing of `layout` and `dispatch` averages.
LAYOUT_SAMPLES = 128
TIMED_CALLS = 20


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _our_name(kernel: str) -> Optional[str]:
  for name in OUR_KERNEL_NAMES:
    if name in kernel:
      return name
  return None


def idle_share(busy_ms: float, step_ms: float) -> float:
  """The device's idle share of a step: 1 - busy / step, where step_ms is
  the unprofiled step's time (the profiler's own host time excluded)."""
  return 1.0 - busy_ms / step_ms


@dataclasses.dataclass
class Profile:
  """One profiled call.

  wall_ms: host time of the call, synchronised, under the profiler.
  busy_ms: device time of every device op (kernels, copies, sets).
  device_ops: their number.
  kernels: device ms by device op name.
  by_op: (device ms, device ops) by op: the port's kernels by kernel
    name, every other device op by the CPU op that launched it (its aten
    name); device time no CPU op launched is under 'unattributed'.
  """
  wall_ms: float
  busy_ms: float
  device_ops: int
  kernels: Dict[str, float]
  by_op: Dict[str, Tuple[float, int]]

  @property
  def ours(self) -> Dict[str, float]:
    """Device ms of each kernel of the port that ran."""
    return {k: v[0] for k, v in self.by_op.items() if k in OUR_KERNEL_NAMES}

  @property
  def collective_ms(self) -> float:
    return sum(ms for name, ms in self.kernels.items()
               if any(mark in name.lower() for mark in COLLECTIVE_MARKS))

  def top_kernels(self, n: Optional[int] = None) -> List[Tuple[str, float]]:
    return sorted(self.kernels.items(), key=lambda kv: -kv[1])[:n]

  def top_ops(self, n: Optional[int] = None
              ) -> List[Tuple[str, float, int]]:
    return sorted(((k, ms, count) for k, (ms, count) in self.by_op.items()),
                  key=lambda op: -op[1])[:n]


def profile(fn: Callable[[], object], device='cuda',
            trace_path: Optional[str] = None) -> Profile:
  """Runs `fn` once under torch.profiler and breaks its device time down.

  The port's kernels are charged by their own names: they launch
  through ctypes, inside an autograd Function's range in a train step
  and inside no CPU op when serving. Every other device op is charged to
  the CPU op it was launched from (the profiler's correlation), so that
  the plain ops read by their aten names. `trace_path` keeps the Chrome
  trace.
  """
  device = torch.device(device)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if device.type == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  _sync(device)
  with torch.profiler.profile(activities=activities) as prof:
    start = time.perf_counter()
    fn()
    _sync(device)
    wall_ms = (time.perf_counter() - start) * 1e3
  if trace_path:
    os.makedirs(os.path.dirname(trace_path) or '.', exist_ok=True)
    prof.export_chrome_trace(trace_path)
  return breakdown(prof.events(), wall_ms)


def profile_spans(fn: Callable[[], object], device='cuda',
                  trace_path: Optional[str] = None
                  ) -> Tuple[Profile, Dict[str, Tuple[float, int, float]]]:
  """`profile(fn, device, trace_path)` and the `span_table` of its Chrome
  trace (a temporary file unless `trace_path` keeps it)."""
  with tempfile.TemporaryDirectory() as scratch:
    path = trace_path or os.path.join(scratch, 'trace.json')
    prof = profile(fn, device, path)
    return prof, span_table(_trace_events(path))


def breakdown(events, wall_ms: float) -> Profile:
  """The Profile of torch.profiler's FunctionEvents (see `profile`)."""
  kernels = collections.Counter()
  busy_us, count = 0.0, 0
  by_op = collections.defaultdict(lambda: [0.0, 0])
  attributed_us = 0.0
  for event in events:
    if event.device_type == torch.autograd.DeviceType.CUDA:
      us = event.device_time_total
      busy_us += us
      count += 1
      kernels[event.name] += us / 1e3
      ours = _our_name(event.name)
      if ours:
        by_op[ours][0] += us / 1e3
        by_op[ours][1] += 1
        attributed_us += us
      continue
    for kernel in event.kernels:
      if _our_name(kernel.name):
        continue  # charged by its own name above
      by_op[event.name][0] += kernel.duration / 1e3
      by_op[event.name][1] += 1
      attributed_us += kernel.duration
  if busy_us - attributed_us > 1.0:
    by_op['unattributed'] = [(busy_us - attributed_us) / 1e3, 0]
  return Profile(wall_ms, busy_us / 1e3, count, dict(kernels),
                 {k: (v[0], v[1]) for k, v in by_op.items()})


def _trace_events(path: str) -> List[dict]:
  with open(path) as f:
    trace = json.load(f)
  return trace['traceEvents'] if isinstance(trace, dict) else trace


def span_table(events: List[dict]) -> Dict[str, Tuple[float, int, float]]:
  """(device ms, device ops, idle ms before them) by the program span that
  launched each device op of a Chrome trace's `events`.

  A device op is charged to the innermost program span (a
  `user_annotation` named in SPANS, as utils.span records it) that
  encloses its launch on the launching thread; one launched on a thread with no span open there (the autograd
  engine's, which runs the backward) to the innermost span open at its
  launch on the thread of a unit span (UNIT_SPANS); ops launched in no
  span to 'unspanned'. The device's idle time between two ops (no op
  running) is charged with the op that ends it.
  """
  spans = collections.defaultdict(list)
  launches, ops = {}, []
  for event in events:
    if 'dur' not in event:
      continue
    cat, args = event.get('cat'), event.get('args') or {}
    start = float(event.get('ts', 0.0))
    end = start + float(event['dur'])
    if cat in DEVICE_CATEGORIES:
      ops.append((start, end, args.get('correlation')))
    elif cat in LAUNCH_CATEGORIES and 'correlation' in args:
      launches[args['correlation']] = (event.get('tid'), start)
    elif cat == 'user_annotation' and event['name'] in SPANS:
      spans[event.get('tid')].append((start, end, event['name']))
  for thread in spans.values():
    thread.sort()
  units = [tid for tid, thread in spans.items()
           if any(name in UNIT_SPANS for _, _, name in thread)]

  def innermost(tid, ts):
    found = None
    for start, end, name in spans.get(tid, ()):
      if start > ts:
        break
      if end >= ts:
        found = name  # a later start that encloses ts lies inside
    return found

  table = collections.defaultdict(lambda: [0.0, 0, 0.0])
  last = None
  for start, end, correlation in sorted(ops):
    tid, ts = launches.get(correlation, (None, None))
    name = None
    for thread in ([tid] + [u for u in units if u != tid]
                   if tid is not None else []):
      name = innermost(thread, ts)
      if name is not None:
        break
    row = table[name or 'unspanned']
    row[0] += (end - start) / 1e3
    row[1] += 1
    if last is not None and start > last:
      row[2] += (start - last) / 1e3
    last = end if last is None else max(last, end)
  return {name: tuple(row) for name, row in table.items()}


def summarize_trace(path: str, top: int = 20) -> Dict[str, object]:
  """Device time of a torch.profiler Chrome trace: total, by device op,
  by the CPU op that launched it (matched by 'External id') and by the
  program span that launched it (`span_table`).

  Returns {'device_ms', 'device_ops', 'by_kernel': [(name, ms, count)],
  'by_op': [(name, ms, count)], 'by_span': [(name, ms, count, idle
  ms)]}, the first two lists the `top` largest, the spans by idle ms.
  """
  events = _trace_events(path)
  op_names = {}
  for event in events:
    if event.get('cat') == 'cpu_op' and 'External id' in event.get(
        'args', {}):
      op_names[event['args']['External id']] = event['name']
  by_kernel = collections.defaultdict(lambda: [0.0, 0])
  by_op = collections.defaultdict(lambda: [0.0, 0])
  total_us, count = 0.0, 0
  for event in events:
    if event.get('cat') not in DEVICE_CATEGORIES:
      continue
    us = float(event.get('dur', 0.0))
    total_us += us
    count += 1
    by_kernel[event['name']][0] += us / 1e3
    by_kernel[event['name']][1] += 1
    op = (_our_name(event['name'])
          or op_names.get(event.get('args', {}).get('External id'))
          or 'unattributed')
    by_op[op][0] += us / 1e3
    by_op[op][1] += 1

  def largest(table):
    return sorted(((k, v[0], v[1]) for k, v in table.items()),
                  key=lambda row: -row[1])[:top]

  return {'device_ms': total_us / 1e3, 'device_ops': count,
          'by_kernel': largest(by_kernel), 'by_op': largest(by_op),
          'by_span': _span_rows(span_table(events))}


def _span_rows(table) -> List[Tuple[str, float, int, float]]:
  """The rows of a span table, the largest idle ms first."""
  return sorted(((name, ms, count, idle)
                 for name, (ms, count, idle) in table.items()),
                key=lambda row: -row[3])


def _say_spans(rows, say):
  say('device ms, device ops and the idle ms before them, by the program '
      'span that launched them:')
  for name, ms, count, idle in rows:
    say(f'  {ms:10.3f} ms {count:6d}x  idle {idle:10.3f} ms  {name}')


def _say(*lines):
  if mesh.is_main():
    for line in lines:
      print(line, flush=True)


def _print_profile(prof: Profile, reference_ms: float, what: str,
                   spans: Optional[Dict[str, Tuple[float, int, float]]] = None):
  _say(f'profiled {what}: {prof.wall_ms:.2f} ms wall, {prof.busy_ms:.2f} ms '
       f'device busy, {prof.device_ops} device ops; idle share '
       f'{idle_share(prof.busy_ms, reference_ms):.3f} against the '
       f'unprofiled median of {reference_ms:.2f} ms',
       'device ms by op (the port\'s kernels by name, the rest by the op '
       'that launched them):')
  for name, ms, count in prof.top_ops():
    share = 100 * ms / max(prof.busy_ms, 1e-9)
    _say(f'  {ms:10.3f} ms {count:6d}x {share:5.1f}%  {name}')
  if spans:
    _say_spans(_span_rows(spans), _say)


# ---------------------------------------------------------------- step

def step_configs(args):
  """The bench workload's (model config, train config) under the flags."""
  model_config, train_config = configs.bench_train_config()
  model_config = dataclasses.replace(model_config,
                                     use_bfloat16=args.bfloat16,
                                     use_fused_mlp=args.fused)
  batch_size = args.batch_size
  if args.preset == 'fullhd':
    # configs/gpu_fullhd.gin: 256 + 256 samples, 10 point freqs, batch 4096.
    model_config = dataclasses.replace(
        model_config, num_coarse_samples=256, num_fine_samples=256,
        num_nerf_point_freqs=10)
    if batch_size == 6144:
      batch_size = 4096
  if args.warp_kwargs:
    kwargs = dict(model_config.warp_kwargs)
    for pair in args.warp_kwargs.split(','):
      key, value = pair.split('=')
      kwargs[key] = {'true': True, 'false': False}.get(value.lower(), value)
    model_config = dataclasses.replace(model_config, warp_kwargs=kwargs)
  use_elastic = args.elastic != 'off'
  train_config = dataclasses.replace(
      train_config, batch_size=batch_size, use_elastic_loss=use_elastic,
      elastic_reduce_method=args.elastic if use_elastic else 'weight',
      use_background_loss=args.background)
  return model_config, train_config


def run_step(args) -> Dict[str, object]:
  """Times the bench step (median and spread), profiles one more step."""
  device = mesh.init(args.device)
  model_config, train_config = step_configs(args)
  if train_config.batch_size % mesh.world_size():
    raise ValueError('Batch size must be divisible by the number of devices.')
  use_elastic = train_config.use_elastic_loss
  model, params = nerf.construct_nerf(
      model_config, **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(0), device=device,
      use_warp_jacobian=(use_elastic
                         and train_config.elastic_reduce_method != 'median'),
      use_weights=use_elastic)
  state = training.create_train_state(params,
                                      warp_alpha=configs.BENCH_WARP_ALPHA)
  step = training.make_train_step(model, train_config, device)
  points = (train_config.background_points_batch_size
            if train_config.use_background_loss else 0)
  points -= points % mesh.world_size()
  batch = mesh.rank_rows(bench.fake_batch(train_config.batch_size,
                                           points))
  if not train_config.use_background_loss:
    batch.pop('background_points')
  scalars = training.ScalarParams(**configs.BENCH_TRAIN_SCALARS)
  route = 'fused' if model.fused_route else 'plain'
  _say(f'step: batch {train_config.batch_size} over {mesh.world_size()} '
       f'rank(s) on {device}, {route} route, elastic {args.elastic}, '
       f'background {args.background}, bfloat16 {args.bfloat16}')

  def run(i, state):
    new_state, stats = step(training.step_generator(0, i, device), state,
                            batch, scalars)
    _sync(device)
    return new_state, stats

  start = time.perf_counter()
  state, _ = run(0, state)
  _say(f'first step (kernel build and first launches): '
       f'{(time.perf_counter() - start) * 1e3:.1f} ms')
  for i in range(1, 3):
    state, _ = run(i, state)
  mesh.collective_stats(reset=True)
  times = []
  for i in range(3, 3 + args.steps):
    start = time.perf_counter()
    state, stats = run(i, state)
    times.append((time.perf_counter() - start) * 1e3)
  collectives = mesh.collective_stats(reset=True)
  median = statistics.median(times)
  loss = float(stats['fine']['loss/rgb']) if 'fine' in stats else float('nan')
  _say(f'unprofiled steps: median {median:.2f} ms (min {min(times):.2f}, max '
       f'{max(times):.2f}, over {len(times)}) -> '
       f'{train_config.batch_size / median * 1e3:.0f} rays/s, loss/rgb '
       f'{loss:.4f}')
  trace_path = (os.path.join(args.trace_dir, f'step_rank{mesh.rank()}.json')
                if args.trace_dir else None)
  prof, spans = profile_spans(lambda: run(3 + args.steps, state), device,
                              trace_path)
  _print_profile(prof, median, 'step', spans)
  result = {'step_ms': times, 'median_ms': median, 'profile': prof,
            'by_span': _span_rows(spans),
            'idle_share': idle_share(prof.busy_ms, median),
            'world_size': mesh.world_size()}
  if mesh.world_size() > 1:
    calls = max(collectives['calls'], 1)
    result['all_reduce'] = {'bytes': collectives['bytes'] // calls,
                            'ms': collectives['ms'] / calls,
                            'profiled_ms': prof.collective_ms}
    clock = 'CUDA events' if device.type == 'cuda' else 'host clock'
    _say(f'all-reduce over {mesh.world_size()} ranks: '
         f'{collectives["bytes"] // calls} bytes and '
         f'{collectives["ms"] / calls:.3f} ms a step ({clock} around the '
         f'collective), {prof.collective_ms:.3f} ms of collective kernels '
         'in the profiled step')
  if trace_path:
    _say(f'trace written; summarise it with:\n'
         f'  python -m nerfies_tpu_torch.profiling trace {trace_path}')
  return result


# -------------------------------------------------------------- render

def run_render(args) -> Dict[str, object]:
  """Render throughput of the bench render model at render_size^2."""
  device = mesh.init(args.device)
  config = dataclasses.replace(configs.bench_render_config(),
                               use_bfloat16=args.bfloat16)
  model, params = nerf.construct_nerf(
      config, **configs.BENCH_RENDER_IDS,
      generator=torch.Generator().manual_seed(0), device=device)
  state = evaluation.RenderState(params, warp_alpha=configs.BENCH_WARP_ALPHA)
  h = w = args.render_size
  rng = np.random.RandomState(0)
  directions = rng.randn(h, w, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  ids = np.zeros((h, w, 1), np.int64)
  rays = {'origins': np.zeros((h, w, 3), np.float32),
          'directions': directions,
          'metadata': {'warp': ids, 'camera': ids, 'appearance': ids}}
  render_fn = evaluation.make_render_fn(model, device=device)
  start = time.perf_counter()
  evaluation.render_image(state, rays, render_fn, chunk=args.chunk)
  _say(f'first render (kernel build and first launches): '
       f'{time.perf_counter() - start:.2f} s')
  out = evaluation.render_image(state, rays, render_fn, chunk=args.chunk)
  _say(f'render {h}x{w}: {out["render_time"]:.3f} s = '
       f'{out["rays_per_sec"]:.0f} rays/s')
  result = {'render_time': out['render_time'],
            'rays_per_sec': out['rays_per_sec']}
  if args.trace_dir:
    path = os.path.join(args.trace_dir, f'render_rank{mesh.rank()}.json')
    prof, spans = profile_spans(lambda: evaluation.render_image(
        state, rays, render_fn, chunk=args.chunk), device, path)
    _print_profile(prof, out['render_time'] * 1e3, 'render', spans)
    result['profile'] = prof
    result['by_span'] = _span_rows(spans)
  return result


# -------------------------------------------------------------- layout

def run_layout(args) -> Dict[str, float]:
  """posenc -> a 6-layer warp-trunk-like product stack, three layouts.

  v0: 3-D products (B, S, C) @ (C, W); v1: the samples flattened into
  2-D products with per-ray adds; v2: posenc zero-padded to 48 channels.
  Forward and backward in bf16 torch.matmul; ms per call of each.
  """
  device = mesh.init(args.device)
  b, s, width, depth, freqs, meta = (args.batch_size, LAYOUT_SAMPLES, 128,
                                     6, 6, 8)
  pe_dim = 3 + 2 * freqs * 3
  gen = torch.Generator(device).manual_seed(0)
  pts = torch.randn((b, s, 3), generator=gen, device=device)
  code = torch.randn((b, 1, meta), generator=gen, device=device,
                     dtype=torch.bfloat16)

  def make_kernels(pdim):
    dims = [(pdim, width), (meta, width)]
    for i in range(1, depth):
      dims += ([(width, width), (pdim, width), (meta, width)] if i == 4
               else [(width, width)])
    return [(0.05 * torch.randn(d, generator=gen, device=device)).to(
        torch.bfloat16).requires_grad_(True) for d in dims]

  def stack(pe, kernels):
    h, k = None, 0
    for i in range(depth):
      inputs = [pe, code] if h is None else ([h, pe, code] if i == 4
                                             else [h])
      out = None
      for x in inputs:
        term = torch.matmul(x, kernels[k])
        k += 1
        out = term if out is None else out + term
      h = torch.relu(out)
    return h

  def v0(kernels):
    return stack(encoding.posenc(pts, freqs).to(torch.bfloat16), kernels)

  def v1(kernels):
    pe = encoding.posenc(pts, freqs).to(torch.bfloat16).reshape(b * s, -1)
    h, k = None, 0
    for i in range(depth):
      if h is None:
        out = (pe @ kernels[0]).reshape(b, s, width) + code @ kernels[1]
        k = 2
      elif i == 4:
        k_h, k_pe, k_meta = kernels[k:k + 3]
        k += 3
        out = ((h.reshape(b * s, width) @ k_h + pe @ k_pe).reshape(
            b, s, width) + code @ k_meta)
      else:
        out = (h.reshape(b * s, width) @ kernels[k]).reshape(b, s, width)
        k += 1
      h = torch.relu(out)
    return h

  def v2(kernels):
    pe = encoding.posenc(pts, freqs).to(torch.bfloat16)
    pe = torch.nn.functional.pad(pe, (0, 48 - pe_dim))
    return stack(pe, kernels)

  flops_fwd = 2 * b * s * ((pe_dim + meta) * width + 4 * width * width
                           + (width + pe_dim + meta) * width)
  result = {}
  for name, fwd, kernels in (('v0 posenc->3D products', v0,
                              make_kernels(pe_dim)),
                             ('v1 flatten->2D products', v1,
                              make_kernels(pe_dim)),
                             ('v2 pad-to-48->3D products', v2,
                              make_kernels(48))):
    def call():
      loss = (fwd(kernels).float() ** 2).mean()
      torch.autograd.grad(loss, kernels)
    call()
    _sync(device)
    start = time.perf_counter()
    for _ in range(TIMED_CALLS):
      call()
    _sync(device)
    ms = (time.perf_counter() - start) * 1e3 / TIMED_CALLS
    result[name] = ms
    _say(f'{name}: {ms:8.3f} ms  ~{3 * flops_fwd / ms / 1e9:7.2f} TFLOP/s '
         '(forward + backward, estimated)')
  return result


# ------------------------------------------------------------ dispatch

def run_dispatch(args) -> Dict[str, float]:
  """The host round trip of one tiny synchronised launch, and the time a
  launch of an asynchronous chain of `n`, synchronised once."""
  device = mesh.init(args.device)
  x = torch.zeros((8, 128), device=device)
  n = TIMED_CALLS

  def fetch(t):
    return t[0, 0].item()  # a copy back, as scripts/profile.py's device_get

  fetch(x + 1.0)
  start = time.perf_counter()
  for _ in range(n):
    fetch(x + 1.0)
  sync_ms = (time.perf_counter() - start) * 1e3 / n
  start = time.perf_counter()
  y = x
  for _ in range(n):
    y = y + 1.0
  fetch(y)
  chain_ms = (time.perf_counter() - start) * 1e3 / n
  _say(f'synced launch round trip: {sync_ms:.4f} ms',
       f'async chain of {n}, one sync: {chain_ms:.4f} ms a launch')
  return {'sync_ms': sync_ms, 'chain_ms': chain_ms}


# --------------------------------------------------------------- trace

def run_trace(args) -> Dict[str, object]:
  summary = summarize_trace(args.path, args.top)
  print(f'== {args.path}: {summary["device_ms"]:.3f} ms of device time in '
        f'{summary["device_ops"]} device ops ==')
  for title, rows in (('by op', summary['by_op']),
                      (f'top {args.top} device ops', summary['by_kernel'])):
    print(f'-- {title} --')
    total = max(summary['device_ms'], 1e-9)
    for name, ms, count in rows:
      print(f'  {ms:10.3f} ms {count:6d}x {100 * ms / total:5.1f}%  {name}')
  if summary['by_span']:
    _say_spans(summary['by_span'], print)
  return summary


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description=__doc__.splitlines()[0],
      formatter_class=argparse.RawDescriptionHelpFormatter, epilog=__doc__)
  sub = parser.add_subparsers(dest='mode', required=True)
  device_help = "torch device; 'cpu' runs the plain versions."

  p_step = sub.add_parser('step')
  p_step.add_argument('--batch_size', type=int, default=6144)
  p_step.add_argument('--preset', choices=['quarterhd', 'fullhd'],
                      default='quarterhd')
  p_step.add_argument('--steps', type=int, default=10)
  p_step.add_argument('--elastic', choices=['weight', 'median', 'off'],
                      default='weight')
  p_step.add_argument('--background', action=argparse.BooleanOptionalAction,
                      default=True)
  p_step.add_argument('--bfloat16', action=argparse.BooleanOptionalAction,
                      default=True)
  p_step.add_argument('--warp_kwargs', default='',
                      help='comma list k=v merged into ModelConfig.'
                           'warp_kwargs, e.g. fuse_branch_heads=false')
  p_step.add_argument('--fused', action=argparse.BooleanOptionalAction,
                      default=True,
                      help='the fused kernels\' route (use_fused_mlp); '
                           '--no-fused takes the plain forward')
  p_step.add_argument('--trace_dir', default='')
  p_step.add_argument('--device', default='cuda', help=device_help)

  p_render = sub.add_parser('render')
  p_render.add_argument('--render_size', type=int, default=384)
  p_render.add_argument('--chunk', type=int, default=8192)
  p_render.add_argument('--bfloat16', action=argparse.BooleanOptionalAction,
                        default=True)
  p_render.add_argument('--trace_dir', default='')
  p_render.add_argument('--device', default='cuda', help=device_help)

  p_dispatch = sub.add_parser('dispatch')
  p_dispatch.add_argument('--device', default='cuda', help=device_help)

  p_layout = sub.add_parser('layout')
  p_layout.add_argument('--batch_size', type=int, default=6144)
  p_layout.add_argument('--device', default='cuda', help=device_help)

  p_trace = sub.add_parser('trace')
  p_trace.add_argument('path')
  p_trace.add_argument('--top', type=int, default=20)
  return parser.parse_args(argv)


MODES = {'step': run_step, 'render': run_render, 'layout': run_layout,
         'dispatch': run_dispatch, 'trace': run_trace}


def main(argv: Optional[Sequence[str]] = None):
  args = parse_args(argv)
  return MODES[args.mode](args)


if __name__ == '__main__':
  main()
  mesh.shutdown()
