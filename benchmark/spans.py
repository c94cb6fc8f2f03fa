"""The program's spans: which phase of the program launched each device op,
and the timing stretch's idle time split by that phase.

The program names its phases with `torch.profiler.record_function` ranges
(`nerfies_tpu_torch.utils.span`), which the attributed stretch records as
`user_annotation` events of the thread that opened them, on the clock of
the device ops. The rule:

  - a device op is charged to the innermost program span that encloses
    its launch on the launching thread;
  - an op launched on a thread with no program span open there (the
    autograd engine's, which runs the backward) is charged to the
    innermost program span open at the launch's time on the thread of a
    unit span (`train.step`, `render.frame`);
  - an idle gap of the timing stretch is charged as `Traced.idle_gaps`
    names it: by the op that ends it, whose span is that of the attributed
    stretch's op at the same place. That holds only where both stretches
    launched the same number of ops; elsewhere there is no split (None).

Time outside the first and last device op, and gaps ended by an op that
no program span launched, are charged to no span (the key None).
"""

import bisect
import collections
from typing import Dict, List, Optional, Sequence

from benchmark import manifest

SPANS = ('data.wait', 'train.to_device', 'train.step', 'train.forward',
         'train.loss', 'train.backward', 'train.all_reduce', 'train.optimizer',
         'kernel.pack', 'render.frame', 'render.rays', 'render.model',
         'render.gather')
UNITS = ('train.step', 'render.frame')


def _innermost(spans, starts: List[float], ts: float) -> Optional[str]:
  """The innermost of `spans` (start, end, name), sorted by start and
  nested on one thread, that encloses `ts`."""
  for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
    if spans[i][1] >= ts:
      return spans[i][2]
  return None


def launch_spans(trace) -> Optional[List[Optional[str]]]:
  """The program span charged with each device op of `trace` (a
  trace.Trace), in the order of the ops' starts; None where the trace
  holds no unit span (a program without spans)."""
  threads = {}
  for tid, ops in trace.host_ops.items():
    spans = [op for op in ops if op[2] in SPANS]
    if spans:
      threads[tid] = (spans, [op[0] for op in spans])
  units = [tid for tid, (spans, _) in threads.items()
           if any(name in UNITS for _, _, name in spans)]
  if not units:
    return None
  charged = []
  for _, _, _, corr in sorted(trace.ops, key=lambda op: op[1]):
    tid, ts = trace.launches.get(corr, (None, None))
    span = None
    if tid is not None:
      for thread in [tid] + [unit for unit in units if unit != tid]:
        span = _innermost(*threads[thread], ts) if thread in threads else None
        if span is not None:
          break
    charged.append(span)
  return charged


def idle_by_span(traced) -> Optional[Dict[Optional[str], float]]:
  """Seconds of the timing stretch's idle device time by the program span
  charged with it (a trace.Traced); None where the stretches launched
  different numbers of ops or the program opened no unit span."""
  timing = sorted(traced.timing.ops, key=lambda op: op[1])
  charged = launch_spans(traced.attributed)
  if not timing or charged is None or len(charged) != len(timing):
    return None
  idle = collections.Counter()
  end = None
  for (_, start, stop, _), span in zip(timing, charged):
    if end is not None and start > end:
      idle[span] += (start - end) / 1e6
    end = stop if end is None else max(end, stop)
  idle[None] += max(0.0, traced.timing.window_s - (end - timing[0][1]) / 1e6)
  return dict(idle)


def idle_share(ctx, kind: str, charged: Sequence[str]) -> Optional[float]:
  """`idle_share.<kind>` (percent of the unprofiled window) times the share
  of the timing stretch's idle time charged to the spans `charged`, so
  that a cell's phases and the rest add up to its `idle_share.<kind>`."""
  if ctx.trace is None:
    return None
  whole = manifest.reader(f'idle_share.{kind}', ctx.cell.root)(ctx)
  idle = idle_by_span(ctx.trace)
  if whole is None or idle is None or sum(idle.values()) <= 0:
    return None
  return whole * sum(idle.get(span, 0.0) for span in charged) / sum(
      idle.values())
