"""The harness on the CPU: the manifest, the lookups by name, a cell of a
new kind on two ranks added from files alone, the imports, the refusal
without a card, the reduction of a trace and the shape of the result
line."""

import ast
import dataclasses
import json
import pathlib
import re
import shutil
import sys

import pytest
import torch

from benchmark import cells
from benchmark import manifest
from benchmark import run
from benchmark import trace as trace_lib
from benchmark.tests import bench_tiny

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


def _manifest():
  return manifest.load_manifest(ROOT)


def test_manifest_follows_the_contract():
  m = _manifest()
  assert set(m) == {'command', 'paths', 'run_seconds', 'configs',
                    'workloads', 'end_to_end', 'per_layer'}
  assert m['paths'] == ['benchmark'] and 1 <= m['run_seconds'] <= 51
  assert all(not w.startswith('/') and '..' not in w for w in m['command'])
  names = []
  for section, keys in KEYS.items():
    for entry in m[section]:
      assert set(entry) - {'workloads'} == keys, entry
      assert NAME.match(entry['name']), entry['name']
      names.append((section, entry['name']))
      for field in ('why', 'layer', 'source'):
        if field in entry:
          assert 1 <= len(entry[field]) <= 200 and '\n' not in entry[field]
      if 'unit' in entry:
        assert UNIT.match(entry['unit']) and entry['better'] in (
            'lower', 'higher')
  assert len(names) == len(set(names))
  assert {e['name'] for e in m['end_to_end']} == {
      'train_rays_per_s', 'render_rays_per_s', 'setup_s'}
  for metric in m['end_to_end']:
    assert 0.01 <= metric['bound'] <= 0.25
  cells = {w['name'] for w in m['workloads']}
  assert cells == {'vrig_paper.train', 'fullhd.train', 'vrig_paper.render'}
  moves = {e['name'] for e in m['end_to_end']}
  for metric in m['per_layer']:
    assert metric['moves'] in moves and set(metric['workloads']) <= cells
  assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize('workload', ['vrig_paper.train', 'fullhd.train',
                                      'vrig_paper.render'])
def test_each_cell_finds_its_files_by_name(workload):
  cell = manifest.load_cell(workload)
  assert cell.config['name'] == cell.config_name
  kind = cells.kind(cell.traffic['kind'], cell)
  assert callable(kind.Runner) and callable(kind.readings)
  assert callable(kind.end_to_end)
  assert cell.limits['numbers']
  names = {m.name for m in cell.end_to_end}
  assert 'setup_s' in names and len(names) == 2
  assert cell.per_layer
  for metric in cell.per_layer:
    assert callable(manifest.reader(metric.name))


def test_a_cell_is_added_from_files_and_entries_alone(tmp_path):
  shutil.copytree(BENCH, tmp_path / 'benchmark',
                  ignore=shutil.ignore_patterns('__pycache__'))
  m = _manifest()
  config = json.loads((BENCH / 'configs' / 'vrig_paper.json').read_text())
  config['name'] = 'dummy'
  (tmp_path / 'benchmark' / 'configs' / 'dummy.json').write_text(
      json.dumps(config))
  traffic = json.loads((BENCH / 'traffic' / 'train_pool16.json').read_text())
  traffic['pool_frames'] = 2
  (tmp_path / 'benchmark' / 'traffic' / 'dummy_pool.json').write_text(
      json.dumps(traffic))
  (tmp_path / 'benchmark' / 'limits' / 'dummy.train.json').write_text(
      json.dumps({'numbers': {'loss_gap': 0.5}}))
  (tmp_path / 'benchmark' / 'metrics' / 'dummy_metric.py').write_text(
      'def read(ctx):\n  return 42.0\n')
  m['configs'].append({'name': 'dummy', 'source': 'https://example.org',
                       'file': 'benchmark/configs/dummy.json',
                       'reduced': [], 'why': 'a test'})
  m['workloads'].append({'name': 'dummy.train', 'config': 'dummy',
                         'traffic': 'dummy_pool', 'chips': 1,
                         'why': 'a test'})
  m['per_layer'].append({'name': 'dummy_metric', 'unit': '%',
                         'better': 'higher', 'source': 'host_clock',
                         'layer': 'Step', 'moves': 'train_rays_per_s',
                         'workloads': ['dummy.train']})
  m['end_to_end'][0]['workloads'].append('dummy.train')
  (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
  cell = manifest.load_cell('dummy.train', root=tmp_path)
  assert cell.traffic['pool_frames'] == 2
  assert cell.limits == {'numbers': {'loss_gap': 0.5}}
  assert 'dummy_metric' in {m.name for m in cell.per_layer}
  assert manifest.reader('dummy_metric', root=tmp_path)(None) == 42.0
  with pytest.raises(KeyError):
    manifest.load_cell('absent.train', root=tmp_path)


PROBE_KIND = '''
"""A probe kind: ranks that meet and all-reduce ones."""
import time

import torch
import torch.distributed as dist

from benchmark import cells


class Runner:

  def __init__(self, cell, seed, place):
    self.place, self.device = place, place.device

  def setup(self):
    self.phases = cells.Phases()
    dist.init_process_group('gloo', init_method=self.place.init_method,
                            rank=self.place.rank,
                            world_size=self.place.world_size)
    self.phases.mark('meet')

  def _one(self):
    ones = torch.ones(4)
    dist.all_reduce(ones)
    self.total = float(ones[0])

  def window(self, seconds):
    start = time.perf_counter()
    for _ in range(3):  # as many on every rank
      self._one()
    return cells.Window(3, 3, time.perf_counter() - start)

  def stretch(self):
    self._one()
    return 1

  def release(self):
    dist.destroy_process_group()

  def check(self):
    return {'sum_gap': abs(self.total - self.place.world_size)}


def end_to_end(windows):
  return {'probe_ops_per_s': sum(w.units for w in windows)
                             / max(w.seconds for w in windows)}


def readings(cell, seed, control, place, window_s):
  return []
'''


def test_a_cell_of_a_new_kind_on_two_ranks_is_added_from_files_alone(
    tmp_path):
  shutil.copytree(BENCH, tmp_path / 'benchmark',
                  ignore=shutil.ignore_patterns('__pycache__'))
  bench = tmp_path / 'benchmark'
  (bench / 'kinds' / 'probe.py').write_text(PROBE_KIND)
  (bench / 'traffic' / 'probe_mix.json').write_text(
      json.dumps({'kind': 'probe'}))
  (bench / 'limits' / 'vrig_paper.probe.json').write_text(
      json.dumps({'numbers': {'sum_gap': 0}}))
  m = _manifest()
  m['workloads'].append({'name': 'vrig_paper.probe', 'config': 'vrig_paper',
                         'traffic': 'probe_mix', 'chips': 2,
                         'why': 'a test'})
  m['end_to_end'].append({'name': 'probe_ops_per_s', 'unit': 'ops/s',
                          'better': 'higher', 'bound': 0.05,
                          'source': 'host_clock',
                          'workloads': ['vrig_paper.probe']})
  (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
  cell = manifest.load_cell('vrig_paper.probe', root=tmp_path)
  assert cell.chips == 2 and cell.root == tmp_path
  result = run.run(cell, 2**31 + 3, 0.2, False, device='cpu',
                   say=lambda line: None)
  assert result['correct'] is True
  assert result['device']['count'] == 2
  assert set(result['metrics']) == {'probe_ops_per_s', 'setup_s'}
  assert result['attempted'] >= 6
  assert result['checked'] == {'sum_gap': {'value': 0.0, 'limit': 0}}


def test_an_unknown_kind_is_refused_by_name(tmp_path):
  cell = manifest.load_cell('vrig_paper.train')
  cell = dataclasses.replace(cell, traffic=dict(cell.traffic, kind='absent'))
  with pytest.raises(KeyError, match='absent'):
    cells.runner(cell, 1, cells.Place(torch.device('cpu')))


def _event(cat, name, ts, dur, **args):
  return {'cat': cat, 'name': name, 'ts': ts, 'dur': dur, 'args': args}


def test_idle_gaps_are_timed_in_one_stretch_and_named_from_the_other():
  # Timing stretch: three device ops, idle 10 us before the second and
  # 30 us before the third, 40 us of host time outside them.
  timing = trace_lib.reduce([
      _event('kernel', 'a', 100, 10, correlation=1),
      _event('kernel', 'b', 120, 10, correlation=2),
      _event('gpu_memcpy', 'Memcpy HtoD', 160, 10, correlation=3),
  ], 120e-6, 1)
  # Attributed stretch: the same ops, slower host, launched by host ops.
  attributed = trace_lib.reduce([
      _event('cpu_op', 'aten::mul', 0, 5, **{'External id': 7}),
      _event('cpu_op', 'aten::copy_', 50, 5, **{'External id': 8}),
      _event('kernel', 'a', 100, 10, correlation=11),
      _event('kernel', 'b', 200, 10, correlation=12, **{'External id': 7}),
      _event('gpu_memcpy', 'Memcpy HtoD', 300, 10, correlation=13,
             **{'External id': 8}),
  ], 300e-6, 1)
  traced = trace_lib.Traced(timing, attributed)
  assert traced.busy_s == pytest.approx(30e-6)
  assert traced.window_s == pytest.approx(120e-6)
  gaps = traced.idle_gaps()
  assert gaps['aten::mul'] == pytest.approx(10e-6)
  assert gaps['aten::copy_'] == pytest.approx(30e-6)
  assert gaps['outside the first and last device op'] == pytest.approx(
      50e-6)
  unmatched = trace_lib.Traced(timing, trace_lib.reduce([], 1.0, 1))
  assert unmatched.idle_gaps()['before Memcpy HtoD'] == pytest.approx(30e-6)
  breakdown = traced.breakdown()
  assert [name for name, _ in breakdown['device_ops']] == [
      'a', 'b', 'Memcpy HtoD']
  # 30 us busy a unit; a window of 4 units in 200 us is 40% idle.
  window = cells.Window(units=4, rays=4, seconds=200e-6)
  context = run.Context(manifest.load_cell('vrig_paper.train'), window,
                        traced, 'cpu')
  for name in ('idle_share.train', 'idle_share.render'):
    assert manifest.reader(name)(context) == pytest.approx(40.0)


def _imports(path: pathlib.Path):
  tree = ast.parse(path.read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob('*.py')
    if '__pycache__' not in p.parts))
def test_no_module_imports_jax_or_the_jax_package(path):
  names = set(_imports(BENCH / path))
  assert not names & {'jax', 'jaxlib', 'flax', 'nerfies_tpu'}
  if path.startswith('reference/'):
    assert not names & {'nerfies_tpu_torch', 'benchmark'}


def test_the_jax_check_compares_whole_names(monkeypatch):
  import nerfies_tpu_torch  # noqa: F401  (its name begins with the JAX package's)
  assert 'nerfies_tpu_torch' in sys.modules
  assert run.forbidden_modules() == []
  monkeypatch.setitem(sys.modules, 'jax.numpy', object())
  monkeypatch.setitem(sys.modules, 'nerfies_tpu', object())
  assert run.forbidden_modules() == ['jax', 'nerfies_tpu']


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch,
                                                         capsys):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  rc = run.main(['--workload', 'vrig_paper.train', '--seed', '1',
                 '--seconds', '1'])
  out = capsys.readouterr()
  assert rc != 0 and out.out == '' and 'needs 1 CUDA card' in out.err


@pytest.mark.parametrize('workload,trace', [
    ('vrig_paper.train', False), ('vrig_paper.render', False),
    ('vrig_paper.train', True)])
def test_a_tiny_run_prints_the_result_keys(workload, trace):
  torch.set_num_threads(2)
  cell = bench_tiny.tiny_cell(workload)
  result = run.run(cell, 2**31 + 99, 0.3, trace, device='cpu',
                   say=lambda line: None)
  required = {'correct', 'attempted', 'failed', 'metrics', 'device'}
  assert required <= set(result)
  assert set(result) - required <= {'breakdown', 'checked'}
  assert list(result)[-1] == 'checked'
  assert result['correct'] is True and result['failed'] == 0
  assert result['attempted'] >= 1
  if not trace:
    assert set(result['metrics']) == {m.name for m in cell.end_to_end}
  else:
    assert 'data_wait_ms' in result['metrics']  # host clock, no card needed
  assert set(result['checked']) == set(cell.limits['numbers'])
  json.dumps(result)
