"""The port's bench (nerfies_tpu_torch/bench.py) against bench.py.

Its fake batch is bench.py's bit for bit; its configs are bench.py's field
for field and its param tree has the names and shapes of bench.py's; one
step of a narrowed bench model matches JAX's step (every draw handed
across, tests/torch_step_parity.py); the FLOP count is the committed
cache's and the MFU keys follow bench.py's arithmetic; the CLI's last line
has bench.py's keys and parses strictly; without a card the CLI fails;
the data-fed bench removes its scene; two gloo ranks
(tests/torch_bench_workers.py) print one line, from rank 0.
"""

import dataclasses
import itertools
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from nerfies_tpu import minigin as jax_gin
from nerfies_tpu.models import nerf as jax_nerf
from nerfies_tpu_torch import bench
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import minigin as gin
from nerfies_tpu_torch import training
from nerfies_tpu_torch.datasets import synthetic
from nerfies_tpu_torch.ops import fused_mlp
from tests import torch_bench_workers
from tests import torch_step_parity
from tests.torch_parity import jax_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
# The keys tests/test_bench_cli.py requires of bench.py's line.
CLI_KEYS = ('metric', 'value', 'unit', 'vs_baseline',
            'render_rays_per_sec_per_chip', 'render_headline_path',
            'render_best_chunk', 'render_chunk_sweep',
            'render_camera_rays_per_sec_per_chip')
# The smallest run that still gives every key: full width and bf16 (the
# CLI has no width flag), about 15 s on one CPU thread.
CLI_ARGV = ('--device', 'cpu', '--skip_data', '--warmup_steps', '1',
            '--bench_steps', '1', '--batch_size', '16', '--render_size', '8',
            '--render_chunks', '32', '64', '--render_reps', '1')
CLI_TIMEOUT_S = 300
# A 2x32 trunk, 4 + 4 samples: the narrowed bench model.
NARROW = dict(nerf_trunk_depth=2, nerf_trunk_width=32, nerf_rgb_branch_width=16,
              nerf_skips=(1,), num_coarse_samples=4, num_fine_samples=4,
              num_nerf_point_freqs=2, num_nerf_viewdir_freqs=1,
              num_warp_freqs=2, num_warp_features=4,
              warp_kwargs={'trunk_depth': 2, 'trunk_width': 16,
                           'skips': (1,)})
NARROW_BATCH = 64


@pytest.fixture(autouse=True)
def no_gin_bindings():
  """Both packages' configs at their defaults, whatever an earlier test
  module of the process bound."""
  for module in (gin, jax_gin):
    module.clear_config()
  yield
  for module in (gin, jax_gin):
    module.clear_config()


@pytest.fixture(scope='module')
def jax_bench():
  """The root bench.py. Importing it points JAX's compile cache at its
  own directory, so the test process's settings are put back right
  after."""
  saved = {name: getattr(jax.config, name) for name in (
      'jax_compilation_cache_dir',
      'jax_persistent_cache_min_compile_time_secs')}
  import bench as module  # pylint: disable=import-outside-toplevel
  for name, value in saved.items():
    jax.config.update(name, value)
  return module


def _narrow(**switches):
  return dataclasses.replace(bench.model_config(**switches), **NARROW)


def _comparable(value):
  """A JAX activation is compared by its name, the port's is that name."""
  return getattr(value, '__name__', value) if callable(value) else value


def _assert_fields_equal(got, want):
  names = {f.name for f in dataclasses.fields(want)}
  assert {f.name for f in dataclasses.fields(got)} == names
  for name in sorted(names):
    assert _comparable(getattr(got, name)) == _comparable(
        getattr(want, name)), name


# ---------------------------------------------------------------- batch

@pytest.mark.parametrize('batch_size', [64, 6144])
@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_fake_batch_is_jax_bit_for_bit(jax_bench, seed, batch_size):
  got = bench.fake_batch(batch_size, seed=seed)
  want = jax_bench.fake_batch(batch_size, seed=seed)
  assert set(got) == set(want) and set(got['metadata']) == set(
      want['metadata'])
  flat = lambda tree: {k: v for k, v in (
      list(tree.items()) + list(tree['metadata'].items())) if k != 'metadata'}
  for key, value in flat(want).items():
    mine = flat(got)[key]
    assert mine.shape == value.shape, key
    np.testing.assert_array_equal(mine, value, err_msg=key)
    if value.dtype == np.uint32:  # an id: the port's ids are int64
      assert mine.dtype == np.int64, key
    else:
      assert mine.dtype == value.dtype, key


# -------------------------------------------------------------- configs

@pytest.mark.parametrize('switches', list(itertools.product([True, False],
                                                            repeat=4)),
                         ids=lambda s: ''.join('TF'[not v] for v in s))
def test_model_config_equals_jax(jax_bench, switches):
  names = ('use_bfloat16', 'use_stratified_sampling', 'use_fused_mlp',
           'use_fused_warp')
  kwargs = dict(zip(names, switches))
  _assert_fields_equal(bench.model_config(**kwargs),
                       jax_bench.model_config(**kwargs))


class _Built(Exception):
  """Ends a run right after its workload is built."""


def test_defaults_are_jax(jax_bench, monkeypatch):
  """model_config trains unfused by default, the CLI fused (bench.py's
  --fused default), and the flags are bench.py's plus --device: the run
  builds its workload through build_workload with the flags'
  switches."""
  _assert_fields_equal(bench.model_config(), jax_bench.model_config())
  assert not bench.model_config().use_fused_mlp
  args = bench.parse_args([])
  assert args.fused and args.fused_warp and args.device == 'cuda'
  assert (args.batch_size, args.warmup_steps, args.bench_steps,
          args.render_size, args.render_chunks, args.render_reps) == (
              6144, 3, 20, 512, [8192, 16384, 32768, 65536], 4)
  built = []
  build = bench.build_workload

  def spy(*a, **kwargs):
    built.append(build(*a, **kwargs))
    raise _Built

  monkeypatch.setattr(bench, 'build_workload', spy)
  with pytest.raises(_Built):
    bench.run(bench.parse_args(['--device', 'cpu']))
  (model, _, train), = built
  assert model.use_fused_mlp and model.use_fused_warp
  assert model.nerf_trunk_width == 256 and train.batch_size == 6144


def test_build_workload_has_jax_names_and_shapes(jax_bench):
  holder = {}

  def build():
    _, params, train_config = jax_bench.build_workload(NARROW_BATCH)
    holder['train_config'] = train_config
    return params

  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(jax, 'device_get', lambda tree: tree)
    shapes = jax.eval_shape(build)
  want = interop.params_from_jax(
      jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), 'cpu')
  _, params, train_config = bench.build_workload(NARROW_BATCH, device='cpu')
  flat = lambda tree: {p: tuple(t.shape)
                       for p, t in fused_mlp.flatten_tree(tree)}
  assert flat(params) == flat(want)
  _assert_fields_equal(train_config, holder['train_config'])


# ----------------------------------------------------------------- step

def test_narrowed_bench_step_matches_jax():
  """One step of the bench's narrowed model on the plain route (float32)
  with the bench's batch, scalars and warp alpha, from the params JAX's
  bench builds (construct_nerf from PRNGKey(0)) at that width.

  Not from random_params: their near-singular warp Jacobians make the
  unweighted coarse/residual/elastic stat (log singular values of J^T J's
  eigenvalues, float32) amplify 1e-7 differences of J to 3e-4, in JAX's
  closed form as in the port's; the loss and every other stat agree to
  1e-7 there too."""
  config = _narrow(use_bfloat16=False)
  _, _, train_config = bench.build_workload(NARROW_BATCH, device='cpu',
                                            config=config)
  assert {k: getattr(train_config, k) for k in torch_step_parity.SWITCHES
          } == torch_step_parity.SWITCHES
  _, params = jax_nerf.construct_nerf(
      jax.random.PRNGKey(0), jax_config(**dataclasses.asdict(config)),
      batch_size=NARROW_BATCH, **configs.BENCH_RENDER_IDS,
      use_warp_jacobian=True, use_weights=True)
  step = torch_step_parity.step_pair(
      config, configs.BENCH_RENDER_IDS, jax.tree.map(np.asarray, params),
      bench.fake_batch(NARROW_BATCH, seed=0), configs.BENCH_TRAIN_SCALARS,
      warp_alpha=configs.BENCH_WARP_ALPHA)
  pair = step()
  assert not pair.fused_route
  assert pair.jax_stats['coarse/loss/elastic'] > 0
  torch_step_parity.check_step(pair, 'plain')


# ---------------------------------------------------------------- flops

@pytest.mark.parametrize('batch_size', [256, 512, 6144])
def test_step_flops_reads_the_committed_cache(batch_size):
  path = REPO / '.flops_cache.json'
  assert bench.FLOPS_CACHE == path
  before = path.read_bytes()
  assert bench.step_flops(batch_size) == json.loads(before)[str(batch_size)]
  assert path.read_bytes() == before  # read only


def test_step_flops_without_a_count():
  assert bench.step_flops(1000) is None
  assert bench.mfu_keys(None, 5.0, 1, 'NVIDIA H100 80GB HBM3') == {}


@pytest.mark.parametrize('device_kind, peak', [
    ('NVIDIA H100 80GB HBM3', 989e12), ('NVIDIA H100 PCIe', 756e12),
    ('NVIDIA H100 NVL', 835e12), ('NVIDIA H100 80GB HBM3 (not a card)', None),
    ('cpu', None)])
@pytest.mark.parametrize('n_chips', [1, 4])
def test_mfu_keys_follow_bench_py(device_kind, peak, n_chips):
  """bench.py:398-407 from a fixed steps/s; only a whole known name has
  a peak (the PCIe part does not read the SXM part's)."""
  flops = bench.step_flops(6144)
  steps_per_sec = 6.25
  want = {'train_step_model_tflops': round(flops / 1e12, 3),
          'model_tflops_per_sec_per_chip': round(
              flops * steps_per_sec / n_chips / 1e12, 2)}
  if peak:
    want['mfu_pct'] = round(100.0 * flops * steps_per_sec / n_chips / peak,
                            2)
  assert bench.mfu_keys(flops, steps_per_sec, n_chips, device_kind) == want
  assert bench.PEAK_BF16_FLOPS.get(device_kind) == peak


# ------------------------------------------------------------------ CLI

def _cli(*argv):
  env = dict(os.environ, OMP_NUM_THREADS='1')
  return subprocess.run(
      [sys.executable, '-m', 'nerfies_tpu_torch.bench', *argv],
      capture_output=True, text=True, timeout=CLI_TIMEOUT_S, env=env,
      cwd=REPO, check=False)


def test_cli_prints_bench_py_line():
  proc = _cli(*CLI_ARGV)
  assert proc.returncode == 0, proc.stderr[-3000:]
  lines = proc.stdout.strip().splitlines()
  assert all(line.startswith('#') for line in lines[:-1]), lines
  parsed = json.loads(lines[-1])
  json.loads(json.dumps(parsed, allow_nan=False))  # RFC-8259 clean
  for key in CLI_KEYS + ('device_kind', 'num_chips',
                         'projected_1080p_frame_seconds_per_chip'):
    assert key in parsed, key
  assert parsed['metric'] == 'train_rays_per_sec_per_chip'
  assert parsed['unit'] == 'rays/s' and parsed['value'] > 0
  assert parsed['vs_baseline'] == round(
      parsed['value'] / bench.BASELINE_RAYS_PER_SEC_PER_GPU, 3)
  assert parsed['device_kind'] == 'cpu' and parsed['num_chips'] == 1
  assert parsed['render_headline_path'] in ('render_camera',
                                            'host_rays_sweep')
  assert set(parsed['render_chunk_sweep']) == {'32', '64'}
  assert str(parsed['render_best_chunk']) in parsed['render_chunk_sweep']
  assert 'render_chunk_errors' not in parsed
  assert 'train_e2e_rays_per_sec_per_chip' not in parsed  # --skip_data
  # The cache has no count at batch 16: no model-FLOPs keys.
  assert 'train_step_model_tflops' not in parsed and 'mfu_pct' not in parsed


def test_cli_without_a_card_fails():
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is valid')
  proc = _cli('--skip_data', '--skip_render')
  assert proc.returncode != 0
  assert 'CUDA card' in proc.stderr
  assert not proc.stdout.strip()
  with pytest.raises(RuntimeError, match='CUDA card'):
    bench.main(['--skip_data', '--skip_render'])


# ---------------------------------------------------------- data-fed

def test_data_fed_bench_removes_its_scene(tmp_path, monkeypatch):
  """bench_train_e2e at the narrowed width on the synthetic scene: a
  positive rate, the scene written under the temporary directory and
  removed after."""
  monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
  written = []
  write = synthetic.write_synthetic_dataset

  def spy(data_dir, **kwargs):
    written.append((pathlib.Path(data_dir), kwargs))
    return write(data_dir, **kwargs)

  monkeypatch.setattr(synthetic, 'write_synthetic_dataset', spy)
  args = bench.parse_args(['--device', 'cpu', '--batch_size',
                           str(NARROW_BATCH), '--warmup_steps', '1',
                           '--bench_steps', '1'])
  model, params, train_config = bench.build_workload(
      args.batch_size, device='cpu', config=_narrow())
  step = training.make_train_step(model, train_config, 'cpu')
  state = training.create_train_state(params,
                                      warp_alpha=configs.BENCH_WARP_ALPHA)
  scalars = training.ScalarParams(**configs.BENCH_TRAIN_SCALARS)
  rate = bench.bench_train_e2e(args, step, state, scalars,
                               torch.device('cpu'))
  assert rate > 0
  assert len(written) == 1
  scene, kwargs = written[0]
  assert scene.parent == tmp_path and not scene.exists()
  assert kwargs == dict(num_train=8, num_val=1, image_size=(256, 192),
                        motion_amplitude=0.05, num_points=16384)
  assert not list(tmp_path.glob('bench_scene_*'))


# ------------------------------------------------------------ two ranks

def test_two_ranks_print_one_line_from_rank_zero(tmp_path):
  argv = ['--device', 'cpu', '--batch_size', str(NARROW_BATCH),
          '--warmup_steps', '1', '--bench_steps', '1', '--render_size', '8',
          '--render_chunks', '32', '64', '--render_reps', '1']
  inputs = dict(config=_narrow(), argv=argv,
                odd_batch_argv=argv[:2] + ['--batch_size', '65'] + argv[4:])
  ranks = torch_bench_workers.spawn(inputs, str(tmp_path), world=2,
                                    target=torch_bench_workers.run_bench)
  outs = []
  for status, value in ranks:
    assert status == 'ok', value
    outs.append(value)
  assert [out['world_size'] for out in outs] == [2, 2]
  lines = outs[0]['stdout'].strip().splitlines()
  assert all(line.startswith('#') for line in lines[:-1]), lines
  parsed = json.loads(lines[-1])
  assert parsed == outs[0]['result']
  assert parsed['num_chips'] == 2 and parsed['device_kind'] == 'cpu'
  assert parsed['train_e2e_rays_per_sec_per_chip'] > 0
  assert set(parsed['render_chunk_sweep']) == {'32', '64'}
  assert outs[1]['stdout'] == ''  # only rank 0 prints
  for out in outs:
    assert 'divisible' in out['odd_batch']
