"""The port's profiling tool (nerfies_tpu_torch/profiling.py) on the CPU.

Each mode runs at a tiny size with --device cpu and prints its lines;
`trace` summarises traces written here; the idle share is taken against
the unprofiled median; without a card and without --device cpu the tool
raises, as every entry point of the port does.
"""

import dataclasses
import json

import pytest
import torch

from nerfies_tpu_torch import configs
from nerfies_tpu_torch import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEP = ['step', '--device', 'cpu', '--batch_size', '8', '--steps', '2']


@pytest.fixture
def few_background_points(monkeypatch):
  """The bench workload with 16 background points a step, not 16,384."""
  bench_train_config = configs.bench_train_config

  def narrowed():
    model_config, train_config = bench_train_config()
    return model_config, dataclasses.replace(
        train_config, background_points_batch_size=16)

  monkeypatch.setattr(configs, 'bench_train_config', narrowed)


def test_idle_share_is_against_the_unprofiled_step():
  assert profiling.idle_share(30.0, 120.0) == pytest.approx(0.75)
  assert profiling.idle_share(120.0, 120.0) == 0.0
  # A profiled wall time longer than the step does not enter the share.
  prof = profiling.Profile(wall_ms=400.0, busy_ms=90.0, device_ops=3,
                           kernels={}, by_op={})
  assert profiling.idle_share(prof.busy_ms, 150.0) == pytest.approx(0.4)


def test_step_prints_the_median_and_the_profiled_step(
    capsys, tmp_path, few_background_points):
  result = profiling.main(STEP + ['--trace_dir', str(tmp_path)])
  out = capsys.readouterr().out
  assert 'unprofiled steps: median' in out
  assert 'profiled step:' in out and 'idle share' in out
  assert 'device ms by op' in out
  assert len(result['step_ms']) == 2
  assert result['median_ms'] == pytest.approx(
      sorted(result['step_ms'])[0] / 2 + sorted(result['step_ms'])[1] / 2)
  assert result['idle_share'] == pytest.approx(profiling.idle_share(
      result['profile'].busy_ms, result['median_ms']))
  assert result['world_size'] == 1 and 'all_reduce' not in result
  assert result['by_span'] == []  # no device op on the CPU
  trace = tmp_path / 'step_rank0.json'
  assert trace.is_file()
  summary = profiling.main(['trace', str(trace)])
  assert summary['device_ops'] == 0  # a CPU run launches no device op
  assert 'ms of device time' in capsys.readouterr().out


@pytest.mark.parametrize('flags', [['--no-fused', '--elastic', 'median'],
                                   ['--elastic', 'off', '--no-background']])
def test_step_variants(capsys, flags, few_background_points):
  result = profiling.main(STEP + flags)
  assert result['median_ms'] > 0
  assert 'route' in capsys.readouterr().out


def test_step_configs_follow_the_flags():
  args = profiling.parse_args(['step', '--preset', 'fullhd', '--no-bfloat16',
                               '--warp_kwargs', 'trunk_depth=4,use_pivot=false',
                               '--elastic', 'median'])
  model, train = profiling.step_configs(args)
  assert (model.num_coarse_samples, model.num_fine_samples,
          model.num_nerf_point_freqs) == (256, 256, 10)
  assert train.batch_size == 4096 and not model.use_bfloat16
  assert model.warp_kwargs['use_pivot'] is False
  assert model.warp_kwargs['trunk_depth'] == '4'
  assert train.elastic_reduce_method == 'median'


def test_render_prints_its_throughput(capsys, tmp_path):
  result = profiling.main(['render', '--device', 'cpu', '--render_size', '6',
                           '--chunk', '16', '--trace_dir', str(tmp_path)])
  out = capsys.readouterr().out
  assert 'render 6x6:' in out and 'rays/s' in out
  assert result['rays_per_sec'] > 0
  assert (tmp_path / 'render_rank0.json').is_file()


def test_layout_times_the_three_formulations(capsys, monkeypatch):
  monkeypatch.setattr(profiling, 'LAYOUT_SAMPLES', 4)
  monkeypatch.setattr(profiling, 'TIMED_CALLS', 2)
  result = profiling.main(['layout', '--device', 'cpu', '--batch_size', '2'])
  assert len(result) == 3 and all(ms > 0 for ms in result.values())
  out = capsys.readouterr().out
  for name in ('v0', 'v1', 'v2'):
    assert name in out


def test_dispatch_prints_both_times(capsys, monkeypatch):
  monkeypatch.setattr(profiling, 'TIMED_CALLS', 3)
  result = profiling.main(['dispatch', '--device', 'cpu'])
  assert set(result) == {'sync_ms', 'chain_ms'}
  out = capsys.readouterr().out
  assert 'round trip' in out and 'async chain of 3' in out


def test_trace_summarises_device_time_by_kernel_and_op(tmp_path, capsys):
  """A Chrome trace as torch.profiler writes it on a card: kernels charged
  to the cpu_op of their External id, the port's kernels by name."""
  events = [
      {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'dur': 50,
       'args': {'External id': 1}},
      {'ph': 'X', 'cat': 'cpu_op', 'name': 'NerfMlpTrain', 'dur': 40,
       'args': {'External id': 2}},
      {'ph': 'X', 'cat': 'kernel', 'name': 'sm90_xmma_gemm_bf16', 'dur': 300,
       'args': {'External id': 1}},
      {'ph': 'X', 'cat': 'kernel', 'name': 'sm90_xmma_gemm_bf16', 'dur': 100,
       'args': {'External id': 1}},
      {'ph': 'X', 'cat': 'kernel', 'name': 'void nerf_mlp_kernel<8>(Args)',
       'dur': 1500, 'args': {'External id': 2}},
      {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'dur': 20,
       'args': {}},
      {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
       'dur': 5, 'args': {'External id': 1}},
  ]
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': events}))
  summary = profiling.main(['trace', str(path), '--top', '5'])
  assert summary['device_ms'] == pytest.approx(1.92)
  assert summary['device_ops'] == 4
  assert summary['by_op'] == [('nerf_mlp_kernel', 1.5, 1),
                              ('aten::mm', 0.4, 2),
                              ('unattributed', 0.02, 1)]
  assert summary['by_kernel'][0] == ('void nerf_mlp_kernel<8>(Args)', 1.5, 1)
  out = capsys.readouterr().out
  assert 'aten::mm' in out and 'nerf_mlp_kernel' in out


def test_breakdown_charges_kernels_by_name_and_the_rest_by_op():
  """The port's kernels by their names, launched inside a CPU op (an
  autograd Function's range) or inside none (serving under no_grad);
  other device ops by the CPU op that launched them; device time that no
  CPU op launched and that is not the port's as 'unattributed'."""
  from torch.autograd import DeviceType
  from torch.autograd.profiler_util import Kernel

  class Event:
    def __init__(self, name, device_type, us=0.0, kernels=()):
      self.name, self.device_type = name, device_type
      self.device_time_total, self.kernels = us, list(kernels)

  events = [
      Event('aten::mm', DeviceType.CPU, kernels=[
          Kernel('sm90_gemm', 0, 300.0), Kernel('sm90_gemm', 0, 100.0)]),
      Event('NerfMlpTrainBackward', DeviceType.CPU, kernels=[
          Kernel('void nerf_bwd_rows_kernel<8>', 0, 2000.0)]),
      Event('sm90_gemm', DeviceType.CUDA, 300.0),
      Event('sm90_gemm', DeviceType.CUDA, 100.0),
      Event('void nerf_bwd_rows_kernel<8>', DeviceType.CUDA, 2000.0),
      Event('void nerf_mlp_kernel<256, 128>', DeviceType.CUDA, 1500.0),
      Event('Memcpy HtoD', DeviceType.CUDA, 50.0),
  ]
  prof = profiling.breakdown(events, wall_ms=10.0)
  assert prof.busy_ms == pytest.approx(3.95) and prof.device_ops == 5
  assert prof.by_op == {'aten::mm': (pytest.approx(0.4), 2),
                        'nerf_bwd_rows_kernel': (pytest.approx(2.0), 1),
                        'nerf_mlp_kernel': (pytest.approx(1.5), 1),
                        'unattributed': (pytest.approx(0.05), 0)}
  assert prof.ours == {'nerf_bwd_rows_kernel': pytest.approx(2.0),
                       'nerf_mlp_kernel': pytest.approx(1.5)}
  assert prof.top_ops(1)[0][0] == 'nerf_bwd_rows_kernel'
  assert prof.kernels['sm90_gemm'] == pytest.approx(0.4)


def test_profile_charges_plain_ops_by_aten_name():
  """On the CPU no device op runs: busy time 0, no op charged."""
  prof = profiling.profile(lambda: torch.ones(4) @ torch.ones(4), 'cpu')
  assert prof.busy_ms == 0 and prof.device_ops == 0 and prof.by_op == {}
  assert prof.wall_ms > 0 and prof.ours == {} and prof.collective_ms == 0


@pytest.mark.parametrize('mode', [['step'], ['render'], ['layout'],
                                  ['dispatch']])
def test_needs_a_card_unless_told_cpu(mode):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is valid')
  with pytest.raises(RuntimeError, match='device="cpu"'):
    profiling.main(mode)


def test_trace_charges_device_ops_to_the_spans_that_launched_them(
    tmp_path, capsys):
  """A Chrome trace with the program's spans: each device op charged to
  the innermost span around its launch on the launching thread; one the
  autograd engine's thread launches outside a span of its own, to the
  step thread's span at its launch; the idle time before each op with
  it."""
  def span(name, ts, dur, tid=1):
    return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': ts,
            'dur': dur, 'tid': tid, 'args': {}}

  def launch(correlation, ts, tid=1):
    return {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
            'ts': ts, 'dur': 1, 'tid': tid,
            'args': {'correlation': correlation}}

  def kernel(correlation, ts, dur):
    return {'ph': 'X', 'cat': 'kernel', 'name': f'k{correlation}', 'ts': ts,
            'dur': dur, 'tid': 7, 'args': {'correlation': correlation}}

  events = [
      span('train.step', 0, 1000), span('train.forward', 100, 300),
      span('kernel.pack', 120, 30), span('train.backward', 400, 300),
      # Not a program span: never charged, even where innermost.
      span('enumerate(DataLoader)', 190, 20),
      span('kernel.pack', 500, 20, tid=2),
      launch(1, 130), launch(2, 200), launch(3, 450, tid=2),
      launch(4, 510, tid=2), launch(5, 1100),
      kernel(1, 2000, 100), kernel(2, 2300, 200), kernel(3, 2500, 1000),
      kernel(4, 3600, 400), kernel(5, 4000, 50),
  ]
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': events}))
  summary = profiling.main(['trace', str(path)])
  rows = {name: (ms, count, idle)
          for name, ms, count, idle in summary['by_span']}
  assert rows == {
      'kernel.pack': (pytest.approx(0.5), 2, pytest.approx(0.1)),
      'train.forward': (pytest.approx(0.2), 1, pytest.approx(0.2)),
      'train.backward': (pytest.approx(1.0), 1, pytest.approx(0.0)),
      'unspanned': (pytest.approx(0.05), 1, pytest.approx(0.0))}
  assert summary['by_span'][0][0] == 'train.forward'  # the most idle first
  out = capsys.readouterr().out
  assert 'by the program span that launched them' in out
  assert 'unspanned' in out and 'train.backward' in out


def test_a_profile_prints_its_span_table(capsys):
  prof = profiling.Profile(
      wall_ms=10.0, busy_ms=4.0, device_ops=3, kernels={}, by_op={})
  profiling._print_profile(prof, 8.0, 'step', {
      'train.optimizer': (1.0, 2, 3.0), 'kernel.pack': (3.0, 1, 0.5)})
  out = capsys.readouterr().out
  lines = out.splitlines()
  table = lines.index(next(l for l in lines if 'program span' in l))
  assert 'train.optimizer' in lines[table + 1]
  assert 'kernel.pack' in lines[table + 2]
  # On the CPU no device op runs: no span is charged with any.
  cpu, spans = profiling.profile_spans(
      lambda: torch.ones(4) @ torch.ones(4), 'cpu')
  assert cpu.device_ops == 0 and spans == {}
