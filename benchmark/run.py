"""Runs one cell of BENCHMARK.json once, on the card, and prints its result.

  python3 benchmark/run.py --workload vrig_paper.train --seed 7 \
      --seconds 20 --trace 0

(or `python3 -m benchmark.run ...`) from the root of a checkout. The run
makes its weights and its capture from --seed, builds the program's
kernels into the checkout at the first run (nerfies_tpu_torch/_build/),
warms up the cell's own shapes, measures for --seconds, and then checks
what the timed path produced against the plain reference. With --trace 1
it also profiles a short steady stretch and reports the per-layer metrics
in place of the end-to-end ones.

A cell on one chip runs in this process. A cell on N chips runs one
process a card (rank r on cuda:r), each with the cell's runner; they meet
at a tcp://localhost address that their `place` gives, and this process
gathers their parts into the one result.

Standard output: lines starting with '#', then one JSON line with
`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown`
with --trace 1), and last `checked`, each compared number with its limit.
Standard error ends with the same numbers, one a line.

Exits 2 without a result where there is no card, or fewer than the cell
asks for, and 3 where JAX or the JAX package was loaded by the end.
"""

import time

START = time.perf_counter()
START_WALL = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import multiprocessing  # noqa: E402
import pathlib  # noqa: E402
import queue as queue_lib  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Callable, Dict, List, Optional, Sequence  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'nerfies_tpu')
RANK_TIMEOUT_S = 1200.0  # a run may take this long where it builds the kernels


def forbidden_modules() -> list:
  """Loaded modules whose top-level name is JAX's, Flax's or the JAX
  package's, compared whole (nerfies_tpu_torch is not nerfies_tpu)."""
  return sorted({name.split('.')[0] for name in sys.modules
                 if name.split('.')[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
  """What a per-layer metric's reader reads."""
  cell: object
  window: object
  trace: object
  device_name: str

  @property
  def model(self) -> Dict:
    return self.cell.config['model']


@dataclasses.dataclass
class Part:
  """What one rank's run gives the result."""
  setup_s: float
  window: object  # cells.Window
  numbers: Dict[str, float]
  peak: int
  device_name: str
  layer_metrics: Dict[str, float]
  busy_s: Optional[float] = None
  window_s: Optional[float] = None
  breakdown: Optional[Dict] = None
  loaded: List[str] = dataclasses.field(default_factory=list)


def run_rank(cell, seed: int, seconds: float, trace: bool, place,
             since: Callable[[], float], say=print) -> Part:
  """One rank's run of `cell` at `place` (a cells.Place); `since()` is
  the seconds from the start of the run."""
  import torch
  from benchmark import cells
  from benchmark import manifest
  from benchmark import trace as trace_lib

  device = place.device
  on_card = device.type == 'cuda'
  if on_card:
    torch.cuda.set_device(device)
    torch.cuda.init()
  runner = cells.runner(cell, seed, place)
  entered = since()
  runner.setup()
  gc.collect()  # each window starts from a collected heap
  setup_s = since()
  phases = {'to_run': entered, **runner.phases.seconds}
  say(f'# {cell.name}: set-up {setup_s:.3f} s: ' + ', '.join(
      f'{k} {v:.3f}' for k, v in phases.items()))
  window = runner.window(seconds)
  say(f'# window: {window.units} units, {window.rays} rays in '
      f'{window.seconds:.4f} s')
  traced = trace_lib.profile(runner.stretch, device) if trace else None
  peak = torch.cuda.max_memory_allocated(device) if on_card else 0
  runner.release()
  numbers = runner.check()
  name = torch.cuda.get_device_name(device) if on_card else 'cpu'
  layer = {}
  if traced is not None:
    context = Context(cell, window, traced, name)
    for metric in cell.per_layer:
      value = manifest.reader(metric.name, cell.root)(context)
      if value is not None:
        layer[metric.name] = value
  part = Part(setup_s, window, numbers, peak, name, layer,
              loaded=forbidden_modules())
  if traced is not None:
    part.busy_s, part.window_s = traced.busy_s, traced.window_s
    part.breakdown = traced.breakdown()
  return part


class Forbidden(Exception):
  """A rank loaded JAX, Flax or the JAX package."""


def _free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _rank_main(cell, seed, seconds, trace, place, start_wall, results):
  say = lambda line: print(f'# rank {place.rank}: {line[2:]}', flush=True)
  try:
    part = run_rank(cell, seed, seconds, trace, place,
                    lambda: time.time() - start_wall, say)
    results.put((place.rank, part, None))
  except BaseException:  # pylint: disable=broad-except
    results.put((place.rank, None, traceback.format_exc()))


def run_ranks(cell, seed: int, seconds: float, trace: bool, device_type: str,
              start_wall: float) -> List[Part]:
  """Runs `cell.chips` ranks, one process each, and waits for all."""
  import torch
  from benchmark import cells
  context = multiprocessing.get_context('spawn')
  results = context.Queue()
  init_method = f'tcp://localhost:{_free_port()}'
  processes = []
  for rank in range(cell.chips):
    device = (torch.device('cuda', rank) if device_type == 'cuda'
              else torch.device(device_type))
    place = cells.Place(device, rank, cell.chips, init_method)
    process = context.Process(
        target=_rank_main,
        args=(cell, seed, seconds, trace, place, start_wall, results))
    process.start()
    processes.append(process)
  parts, errors = {}, []
  deadline = time.time() + RANK_TIMEOUT_S
  try:
    while len(parts) + len(errors) < len(processes):
      try:
        rank, part, error = results.get(timeout=1.0)
      except queue_lib.Empty:
        died = [p for p in processes if p.exitcode not in (None, 0)]
        if died or time.time() > deadline:
          errors.append(f'{len(died)} rank(s) ended with no result')
          break
        continue
      if error is None:
        parts[rank] = part
      else:
        errors.append(f'rank {rank}:\n{error}')
  finally:
    for process in processes:
      process.join(timeout=60)
      if process.is_alive():
        process.terminate()
        process.join()
  if errors:
    raise RuntimeError('\n'.join(errors))
  loaded = sorted({m for part in parts.values() for m in part.loaded})
  if loaded:
    raise Forbidden(loaded)
  return [parts[rank] for rank in range(cell.chips)]


def run(cell, seed: int, seconds: float, trace: bool, device='cuda',
        say=print) -> Dict:
  """Runs `cell` once on `device` ('cuda' or 'cpu'); returns the result's
  dict."""
  import torch
  from benchmark import cells
  if cell.chips == 1:
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
      device = torch.device('cuda', 0)
    place = cells.Place(device)
    parts = [run_rank(cell, seed, seconds, trace, place,
                      lambda: time.perf_counter() - START, say)]
  else:
    parts = run_ranks(cell, seed, seconds, trace, torch.device(device).type,
                      START_WALL)
  return combine(cell, parts, trace)


def combine(cell, parts: List[Part], trace: bool) -> Dict:
  """The result of a run from its ranks' parts: each number compared is
  the worst rank's, the end-to-end metrics the kind's of all windows."""
  from benchmark import cells
  from benchmark import compare
  numbers = {}
  for part in parts:
    for name, value in part.numbers.items():
      numbers[name] = max(numbers.get(name, -math.inf), value)
  correct, rows = compare.judge(numbers, cell.limits['numbers'])
  windows = [part.window for part in parts]
  first = parts[0]
  metrics = {}
  if not trace:
    values = dict(cells.kind(cell.traffic['kind'], cell).end_to_end(windows),
                  setup_s=max(part.setup_s for part in parts))
    for metric in cell.end_to_end:
      if metric.name in values:
        metrics[metric.name] = {'value': values[metric.name],
                                'unit': metric.unit}
  else:
    for metric in cell.per_layer:
      if metric.name in first.layer_metrics:
        metrics[metric.name] = {'value': first.layer_metrics[metric.name],
                                'unit': metric.unit}
  on_card = first.device_name != 'cpu'
  result = {
      'correct': bool(correct),
      'attempted': sum(w.units for w in windows),
      'failed': sum(w.failed for w in windows),
      'metrics': metrics,
      'device': {'platform': 'gpu' if on_card else 'cpu',
                 'kind': first.device_name, 'count': len(parts),
                 'memory_peak_bytes': max(part.peak for part in parts)},
  }
  if trace and first.busy_s is not None:
    result['device']['busy_s'] = sum(p.busy_s for p in parts) / len(parts)
    result['device']['window_s'] = max(p.window_s for p in parts)
    result['breakdown'] = first.breakdown
  result['checked'] = {n: {'value': _json_number(v), 'limit': limit}
                       for n, v, limit in rows}
  return result


def _json_number(x: float):
  return x if math.isfinite(x) else str(x)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
  args = parse_args(argv)
  from benchmark import manifest
  cell = manifest.load_cell(args.workload)
  import torch
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f'{cell.name} needs {cell.chips} CUDA card(s); found {found}',
          file=sys.stderr)
    return 2
  try:
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
  except Forbidden as found:
    loaded = found.args[0]
  if loaded:
    print(f'the run loaded {", ".join(loaded)}; no result', file=sys.stderr)
    return 3
  for name, row in result['checked'].items():
    print(f'{name} {row["value"]} limit {row["limit"]}', file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
