"""torch.profiler over a short steady stretch, reduced to what the readers need.

On the card the stretch runs twice under `torch.profiler.profile`:

  timing      CUDA activity alone, so that the host runs at nearly its
              unprofiled pace: the device's busy time, the idle share, the
              device ops by name and the idle gaps come from it;
  attributed  CPU and CUDA activities, whose per-op host recording slows
              the host down: it only tells which host op launched each
              device op (a reader's `inside` filter, the names of the
              timing stretch's idle gaps).

Each Chrome trace is written under TMPDIR, read back and deleted. Device
work is every 'kernel', 'gpu_memcpy' and 'gpu_memset' event. The device's
busy time is the union of their intervals; an idle gap is a stretch
between them, named by the host op that launched the device op ending it
(the op at the same place in the attributed stretch, whose steps launch
the same ops in the same order), or, where the two stretches launched
different numbers of ops, by that device op. Device time by name follows
the arithmetic of the program's `profiling.breakdown` (sums of device
durations by name), copied here so that the yardstick stays put.
"""

import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATEGORIES = ('cuda_runtime', 'cuda_driver')


@dataclasses.dataclass
class Trace:
  """The device side of one profiled stretch."""
  window_s: float  # host clock around the stretch, ending in a synchronise
  units: int  # steps or frames inside the stretch
  ops: List[Tuple[str, float, float, Optional[int]]]  # name, start, end (us), correlation
  launches: Dict[int, Tuple[int, float]]  # correlation -> (tid, ts us)
  host_ops: Dict[int, List[Tuple[float, float, str]]]  # tid -> sorted cpu ops
  op_of_kernel: Dict[int, str]  # correlation -> launching cpu op name

  @property
  def busy_s(self) -> float:
    total, end = 0.0, float('-inf')
    for _, start, stop, _ in sorted(self.ops, key=lambda op: op[1]):
      if stop <= end:
        continue
      total += stop - max(start, end)
      end = stop
    return total / 1e6

  def device_s_by_name(self) -> Dict[str, float]:
    """Device seconds by op name, kernels named without 'void', their
    namespace and their argument list."""
    by_name = collections.Counter()
    for name, start, stop, _ in self.ops:
      by_name[short_name(name)] += (stop - start) / 1e6
    return dict(by_name)

  def device_s(self, name_parts: Sequence[str],
               inside: Optional[str] = None) -> float:
    """Device seconds of the ops whose name holds one of `name_parts`,
    launched (if `inside` is given) within a host op whose name holds it."""
    spans = {tid: [(s, e) for s, e, n in ops if inside in n]
             for tid, ops in self.host_ops.items()} if inside else None
    total = 0.0
    for name, start, stop, corr in self.ops:
      if not any(part in name for part in name_parts):
        continue
      if spans is not None:
        tid, ts = self.launches.get(corr, (None, None))
        if tid is None or not any(s <= ts <= e for s, e in spans.get(tid, ())):
          continue
      total += (stop - start) / 1e6
    return total


def short_name(name: str) -> str:
  """'void (anonymous namespace)::k<256>((anonymous namespace)::A)' ->
  'k<256>'; other names as they are."""
  if not name.startswith('void '):
    return name
  name = name[len('void '):].replace('(anonymous namespace)::', '')
  depth = 0
  for i, ch in enumerate(name):
    if ch == '<':
      depth += 1
    elif ch == '>':
      depth -= 1
    elif ch == '(' and depth == 0 and i > 0:
      return name[:i]
  return name


@dataclasses.dataclass
class Traced:
  """The two profiled stretches of a traced run."""
  timing: Trace
  attributed: Trace

  @property
  def busy_s(self) -> float:
    return self.timing.busy_s

  @property
  def window_s(self) -> float:
    return self.timing.window_s

  def idle_gaps(self) -> Dict[str, float]:
    """Seconds of idle device time in the timing stretch, by the host op
    that launched the device op after each gap."""
    timing = sorted(self.timing.ops, key=lambda op: op[1])
    attributed = sorted(self.attributed.ops, key=lambda op: op[1])
    same = len(timing) == len(attributed)
    gaps = collections.Counter()
    end = None
    for i, (name, start, stop, _) in enumerate(timing):
      if end is not None and start > end:
        if same:
          label = self.attributed.op_of_kernel.get(attributed[i][3],
                                                   'unattributed')
        else:
          label = 'before ' + short_name(name)
        gaps[label] += (start - end) / 1e6
      end = stop if end is None else max(end, stop)
    if timing:
      span = (end - timing[0][1]) / 1e6
      gaps['outside the first and last device op'] += max(
          0.0, self.timing.window_s - span)
    return dict(gaps)

  def breakdown(self, top: int = 10) -> Dict[str, list]:
    largest = lambda table: [[k, v] for k, v in sorted(
        table.items(), key=lambda kv: -kv[1])[:top]]
    return {'device_ops': largest(self.timing.device_s_by_name()),
            'idle_gaps': largest(self.idle_gaps())}


def profile(stretch: Callable[[], int], device) -> Traced:
  """Runs `stretch` (returns its step or frame count) under the profiler:
  on the card twice, as `Traced` says; on the CPU once."""
  from torch.profiler import ProfilerActivity
  if torch.device(device).type != 'cuda':
    trace = _profiled(stretch, device, [ProfilerActivity.CPU])
    return Traced(trace, trace)
  timing = _profiled(stretch, device, [ProfilerActivity.CUDA])
  attributed = _profiled(stretch, device,
                         [ProfilerActivity.CPU, ProfilerActivity.CUDA])
  return Traced(timing, attributed)


def _profiled(stretch: Callable[[], int], device, activities) -> Trace:
  on_card = torch.device(device).type == 'cuda'
  sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
      lambda: None)
  sync()
  with torch.profiler.profile(activities=activities) as prof:
    start = time.perf_counter()
    units = stretch()
    sync()
    window_s = time.perf_counter() - start
  fd, path = tempfile.mkstemp(suffix='.json')
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)
  finally:
    os.remove(path)
  if isinstance(events, dict):
    events = events.get('traceEvents', [])
  return reduce(events, window_s, units)


def reduce(events: List[dict], window_s: float, units: int) -> Trace:
  """The Trace of a Chrome trace's events."""
  ops, launches, host_ops = [], {}, collections.defaultdict(list)
  by_external = {}
  for e in events:
    cat, args = e.get('cat'), e.get('args') or {}
    if 'dur' not in e:
      continue
    ts, dur = float(e['ts']), float(e['dur'])
    if cat in DEVICE_CATEGORIES:
      ops.append((e['name'], ts, ts + dur, args.get('correlation'),
                  args.get('External id')))
    elif cat in LAUNCH_CATEGORIES and 'correlation' in args:
      launches[args['correlation']] = (e.get('tid'), ts)
    elif cat in ('cpu_op', 'user_annotation', 'python_function'):
      host_ops[e.get('tid')].append((ts, ts + dur, e['name']))
      if 'External id' in args and cat == 'cpu_op':
        by_external[args['External id']] = e['name']
  for tid in host_ops:
    host_ops[tid].sort()
  op_of_kernel = {}
  for name, _, _, corr, external in ops:
    if external in by_external:
      op_of_kernel[corr] = by_external[external]
  return Trace(window_s, units, [op[:4] for op in ops], launches,
               dict(host_ops), op_of_kernel)
