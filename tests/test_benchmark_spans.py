"""The benchmark's split of idle time by program span (benchmark/spans.py)
and its nine readers, on synthetic Chrome-trace events put through
`trace.reduce`, as torch.profiler writes them on a card.

The attributed stretch records host ops and the program's spans
(`user_annotation`), with each device op's launch (`cuda_runtime`, tid and
time); the timing stretch records device ops alone. Imports no JAX.
"""

import pytest

from benchmark import cells
from benchmark import manifest
from benchmark import run
from benchmark import spans as spans_lib
from benchmark import trace as trace_lib

MAIN, ENGINE = 1, 2


def _event(cat, name, ts, dur, tid=MAIN, **args):
  return {'cat': cat, 'name': name, 'ts': ts, 'dur': dur, 'tid': tid,
          'args': args}


def _span(name, start, end, tid=MAIN):
  return _event('user_annotation', name, start, end - start, tid)


def _attributed(spans, launches, window_s=1.0):
  """A stretch of `spans` whose device op k is launched at launches[k] =
  (tid, ts); the device ops run back to back after the host is done."""
  events = list(spans)
  for k, (tid, ts) in enumerate(launches):
    events.append(_event('cuda_runtime', 'cudaLaunchKernel', ts, 1, tid,
                         correlation=100 + k))
    events.append(_event('kernel', f'k{k}', 10_000 + 10 * k, 5, 0,
                         correlation=100 + k))
  return trace_lib.reduce(events, window_s, 1)


def _timing(gaps, busy=10.0, window_s=None):
  """A stretch of len(gaps) device ops of `busy` us each, op k after an
  idle gap of gaps[k] us (gaps[0] is not a gap: it comes before the first
  op); the window is the ops' span plus 40 us unless given."""
  events, t = [], 0.0
  for k, gap in enumerate(gaps):
    t += gap if k else 0.0
    events.append(_event('kernel', f'k{k}', t, busy, 0, correlation=k))
    t += busy
  return trace_lib.reduce(events, window_s or (t + 40.0) / 1e6, 1)


# A train step on the main thread, the autograd engine's thread launching
# the backward; each launch with the span it is charged with.
TRAIN_SPANS = [
    _span('data.wait', -50, -10),
    _span('train.step', 0, 1000),
    _span('train.to_device', 10, 50),
    _span('train.forward', 100, 300),
    _span('kernel.pack', 120, 150),
    _span('train.loss', 300, 400),
    _span('train.backward', 400, 700),
    _span('kernel.pack', 500, 520, ENGINE),
    _span('train.optimizer', 750, 950),
]
TRAIN_LAUNCHES = [
    ((MAIN, 5), 'train.step'),  # in the step, in no phase of it
    ((MAIN, 20), 'train.to_device'),
    ((MAIN, 130), 'kernel.pack'),  # innermost: pack inside the forward
    ((MAIN, 200), 'train.forward'),
    ((MAIN, 350), 'train.loss'),
    ((ENGINE, 450), 'train.backward'),  # the unit thread's span at 450
    ((ENGINE, 510), 'kernel.pack'),  # the engine thread's own span
    ((MAIN, 800), 'train.optimizer'),
    ((MAIN, 1100), None),  # after the step: no span
]
TRAIN_GAPS = [0.0, 3.0, 5.0, 7.0, 11.0, 13.0, 17.0, 19.0, 23.0]

RENDER_SPANS = [
    _span('render.frame', 0, 1000),
    _span('render.rays', 10, 40),
    _span('render.rays', 50, 100),
    _span('render.model', 100, 500),
    _span('kernel.pack', 110, 130),
    _span('render.gather', 600, 900),
]
RENDER_LAUNCHES = [
    ((MAIN, 5), 'render.frame'),
    ((MAIN, 20), 'render.rays'),
    ((MAIN, 60), 'render.rays'),
    ((MAIN, 120), 'kernel.pack'),
    ((MAIN, 200), 'render.model'),
    ((MAIN, 550), 'render.frame'),  # in the frame, in no phase of it
    ((MAIN, 700), 'render.gather'),
]
RENDER_GAPS = [0.0, 2.0, 3.0, 5.0, 7.0, 11.0, 13.0]


def _traced(spans, launches, gaps):
  return trace_lib.Traced(_timing(gaps),
                          _attributed(spans, [l for l, _ in launches]))


def _expected_idle(launches, gaps):
  """The idle seconds by span that the rule gives: gap k to the span of
  launch k, and the 40 us outside the ops to no span."""
  idle = {None: 40e-6}
  for (_, span), gap in list(zip(launches, gaps))[1:]:
    idle[span] = idle.get(span, 0.0) + gap / 1e6
  return idle


def _context(workload, traced, units=4, seconds=None):
  busy = traced.timing.busy_s
  window = cells.Window(units=units, rays=units,
                        seconds=seconds or 2.5 * busy * units)
  return run.Context(manifest.load_cell(workload), window, traced, 'cpu')


@pytest.mark.parametrize('spans,launches', [
    (TRAIN_SPANS, TRAIN_LAUNCHES), (RENDER_SPANS, RENDER_LAUNCHES)],
                         ids=['train', 'render'])
def test_each_launch_is_charged_to_its_innermost_span(spans, launches):
  """Innermost span wins; an engine-thread launch with no span of its own
  falls back to the unit thread's span at its time."""
  trace = _attributed(spans, [l for l, _ in launches])
  assert spans_lib.launch_spans(trace) == [s for _, s in launches]


@pytest.mark.parametrize('spans,launches,gaps', [
    (TRAIN_SPANS, TRAIN_LAUNCHES, TRAIN_GAPS),
    (RENDER_SPANS, RENDER_LAUNCHES, RENDER_GAPS)], ids=['train', 'render'])
def test_each_gap_is_charged_to_the_op_that_ends_it(spans, launches, gaps):
  idle = spans_lib.idle_by_span(_traced(spans, launches, gaps))
  want = _expected_idle(launches, gaps)
  assert idle.keys() == want.keys()
  for span, seconds in want.items():
    assert idle[span] == pytest.approx(seconds), span
  # The split is the whole of the timing stretch's idle time.
  traced = _traced(spans, launches, gaps)
  assert sum(idle.values()) == pytest.approx(traced.window_s
                                             - traced.busy_s)


TRAIN_READERS = {
    'idle_share.train.input': ('train.to_device', 'data.wait'),
    'idle_share.train.forward': ('train.forward',),
    'idle_share.train.loss': ('train.loss',),
    'idle_share.train.backward': ('train.backward',),
    'idle_share.train.optimizer': ('train.optimizer',),
    'idle_share.train.pack': ('kernel.pack',),
}
RENDER_READERS = {
    'idle_share.render.rays': ('render.rays',),
    'idle_share.render.model': ('render.model', 'kernel.pack'),
    'idle_share.render.gather': ('render.gather',),
}
READERS = [(name, 'vrig_paper.train', charged, TRAIN_SPANS, TRAIN_LAUNCHES,
            TRAIN_GAPS) for name, charged in TRAIN_READERS.items()] + [
                (name, 'vrig_paper.render', charged, RENDER_SPANS,
                 RENDER_LAUNCHES, RENDER_GAPS)
                for name, charged in RENDER_READERS.items()]


@pytest.mark.parametrize('name,workload,charged,spans,launches,gaps',
                         READERS, ids=[r[0] for r in READERS])
def test_each_reader_is_its_phases_share_of_the_idle_share(
    name, workload, charged, spans, launches, gaps):
  traced = _traced(spans, launches, gaps)
  context = _context(workload, traced)
  kind = workload.split('.')[1]
  whole = manifest.reader(f'idle_share.{kind}')(context)
  assert whole == pytest.approx(60.0)  # busy 2/5 of the window
  want = _expected_idle(launches, gaps)
  share = sum(want.get(span, 0.0) for span in charged) / sum(want.values())
  assert manifest.reader(name)(context) == pytest.approx(whole * share)
  assert 0.0 < manifest.reader(name)(context) < whole


@pytest.mark.parametrize('workload,readers,spans,launches,gaps', [
    ('vrig_paper.train', TRAIN_READERS, TRAIN_SPANS, TRAIN_LAUNCHES,
     TRAIN_GAPS),
    ('vrig_paper.render', RENDER_READERS, RENDER_SPANS, RENDER_LAUNCHES,
     RENDER_GAPS)], ids=['train', 'render'])
def test_a_cells_phases_and_the_rest_sum_to_its_idle_share(
    workload, readers, spans, launches, gaps):
  traced = _traced(spans, launches, gaps)
  context = _context(workload, traced)
  kind = workload.split('.')[1]
  whole = manifest.reader(f'idle_share.{kind}')(context)
  phases = sum(manifest.reader(name)(context) for name in readers)
  idle = spans_lib.idle_by_span(traced)
  charged = {span for spans_ in readers.values() for span in spans_}
  rest = whole * sum(s for span, s in idle.items()
                     if span not in charged) / sum(idle.values())
  assert phases + rest == pytest.approx(whole)
  assert rest > 0  # the time outside the ops, and the unit span's own


@pytest.mark.parametrize('name', sorted(TRAIN_READERS) + sorted(
    RENDER_READERS))
def test_stretches_of_unequal_op_counts_give_none(name):
  train = name.startswith('idle_share.train')
  spans, launches, gaps = ((TRAIN_SPANS, TRAIN_LAUNCHES, TRAIN_GAPS) if train
                           else (RENDER_SPANS, RENDER_LAUNCHES, RENDER_GAPS))
  traced = trace_lib.Traced(
      _timing(gaps + [2.0]), _attributed(spans, [l for l, _ in launches]))
  assert spans_lib.idle_by_span(traced) is None
  workload = 'vrig_paper.train' if train else 'vrig_paper.render'
  assert manifest.reader(name)(_context(workload, traced)) is None


@pytest.mark.parametrize('name', sorted(TRAIN_READERS) + sorted(
    RENDER_READERS))
def test_a_program_without_spans_or_ops_reads_nothing(name):
  """A program that opens no span (an older one) and a CPU run (no device
  op) give no reading, and raise nothing."""
  workload = ('vrig_paper.train' if name.startswith('idle_share.train')
              else 'vrig_paper.render')
  unspanned = trace_lib.Traced(
      _timing(TRAIN_GAPS),
      _attributed([], [l for l, _ in TRAIN_LAUNCHES]))
  assert spans_lib.launch_spans(unspanned.attributed) is None
  assert manifest.reader(name)(_context(workload, unspanned)) is None
  empty = trace_lib.reduce([_span('train.step', 0, 10)], 1e-3, 1)
  cpu = trace_lib.Traced(empty, empty)
  assert manifest.reader(name)(
      run.Context(manifest.load_cell(workload),
                  cells.Window(units=1, rays=1, seconds=1.0), cpu,
                  'cpu')) is None
  assert manifest.reader(name)(
      run.Context(manifest.load_cell(workload),
                  cells.Window(units=1, rays=1, seconds=1.0), None,
                  'cpu')) is None


def test_the_readers_are_listed_for_the_cells_that_report_their_metric():
  m = manifest.load_manifest()
  entries = {e['name']: e for e in m['per_layer']}
  for name in TRAIN_READERS:
    assert entries[name]['moves'] == 'train_rays_per_s'
    assert entries[name]['workloads'] == ['vrig_paper.train', 'fullhd.train']
  for name in RENDER_READERS:
    assert entries[name]['moves'] == 'render_rays_per_s'
    assert entries[name]['workloads'] == ['vrig_paper.render']
  for name in list(TRAIN_READERS) + list(RENDER_READERS):
    assert entries[name]['unit'] == '%'
    assert entries[name]['source'] == 'device_trace'
    assert entries[name]['better'] == 'lower'
    assert name in {m.name for m in manifest.load_cell(
        entries[name]['workloads'][0]).per_layer}
