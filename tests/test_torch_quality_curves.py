"""scripts/compare_quality_curves.py on made-up curves, and the form of the
port's committed H100 quality curve (its rows are not held to the bar
here: that is a reading of the card, not of this checkout). Imports no
JAX."""

import copy
import hashlib
import importlib.util
import json
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_CURVE = REPO / 'docs' / 'quality_curve.json'
# The fused route's 6,000-step curves of an H100 (seeds 0, 1, 3 and 4).
H100_CURVES = [REPO / 'nerfies_tpu_torch' / 'curves' / name for name in (
    'quality_curve_h100.json', 'quality_curve_h100_fused_seed1.json',
    'quality_curve_h100_fused_seed3.json',
    'quality_curve_h100_fused_seed4.json')]
# The same from JAX's PRNGKey(0) init (the committed npz), with the steps'
# draws of seeds 0 and 1, an eval every 500 steps.
JAX_INIT_CURVES = [REPO / 'nerfies_tpu_torch' / 'curves' / name for name in (
    'quality_curve_h100_jax_init_seed0.json',
    'quality_curve_h100_jax_init_seed1.json')]
JAX_INIT_NPZ = (REPO / 'nerfies_tpu_torch' / 'curves' / 'init'
                / 'quality_init_jax_key0.npz')
STEPS = (2000, 4000, 6000)


def _script():
  spec = importlib.util.spec_from_file_location(
      'compare_quality_curves', REPO / 'scripts' / 'compare_quality_curves.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


compare_quality_curves = _script()


def _curve(rows):
  return {'steps': 20000, 'curve': rows}


REFERENCE = _curve([
    {'step': step, 'val_psnr': psnr, 'train_view_psnr': psnr - 0.5,
     'val_ms_ssim': ssim, 'train_loss': loss}
    for step, psnr, ssim, loss in ((2000, 33.8, 0.9877, 3.75e-4),
                                   (4000, 37.0, 0.9949, 1.87e-4),
                                   (6000, 39.1, 0.9970, 1.23e-4))])


def _inside_the_bar():
  """Each metric just inside its limit at every step."""
  curve = copy.deepcopy(REFERENCE)
  for row in curve['curve']:
    row['val_psnr'] -= 0.99
    row['train_view_psnr'] -= 0.99
    row['val_ms_ssim'] -= 0.0049
    row['train_loss'] *= 1.49
  return curve


def _run(tmp_path, candidate, *extra):
  paths = []
  for name, curve in (('reference', REFERENCE), ('candidate', candidate)):
    paths.append(tmp_path / f'{name}.json')
    paths[-1].write_text(json.dumps(curve))
  return compare_quality_curves.main([str(p) for p in paths] + list(extra))


def test_a_curve_inside_the_bar_passes(tmp_path, capsys):
  assert _run(tmp_path, _inside_the_bar(), '--steps', *map(str, STEPS)) == 0
  out = capsys.readouterr().out
  assert out.count('meets the bar') == 3 and out.splitlines()[-1] == 'OK'
  assert '2000 | -0.99000 | -0.99000 | -0.004900 | 1.4900' in out


@pytest.mark.parametrize('key,change', [
    ('val_psnr', lambda v: v - 1.01),
    ('train_view_psnr', lambda v: v - 1.01),
    ('val_ms_ssim', lambda v: v - 0.0051),
    ('train_loss', lambda v: v * 1.51),
    ('val_ms_ssim', lambda v: None),
])
def test_a_row_outside_the_bar_fails(tmp_path, capsys, key, change):
  candidate = _inside_the_bar()
  row = candidate['curve'][1]
  row[key] = change(row[key])
  assert _run(tmp_path, candidate) == 1
  out = capsys.readouterr().out
  metric = {'val_psnr': 'd_val_psnr', 'train_view_psnr': 'd_train_view_psnr',
            'val_ms_ssim': 'd_val_ms_ssim', 'train_loss': 'loss_ratio'}[key]
  assert '4000 | ' in out and f'misses: {metric}' in out
  assert out.count('meets the bar') == 2 and out.splitlines()[-1] == 'FAIL'


def test_a_shorter_curve_compares_the_shared_steps(tmp_path, capsys):
  candidate = _inside_the_bar()
  del candidate['curve'][2]
  assert _run(tmp_path, candidate) == 0
  assert capsys.readouterr().out.count('meets the bar') == 2
  assert _run(tmp_path, candidate, '--steps', *map(str, STEPS)) == 1
  out = capsys.readouterr().out
  assert '6000 | missing from the candidate' in out
  assert out.splitlines()[-1] == 'FAIL'
  assert _run(tmp_path, _curve([{'step': 100, 'val_psnr': 20.0}])) == 1
  assert 'no step in both curves' in capsys.readouterr().out


@pytest.mark.parametrize('path', H100_CURVES + JAX_INIT_CURVES,
                         ids=lambda p: p.name)
def test_the_h100_curve_has_the_jax_curves_form(path):
  """JAX's keys, rows at 2,000, 4,000 and 6,000 steps of finite readings,
  and the card and its power limit as nvidia-smi prints them."""
  jax_curve = json.loads(JAX_CURVE.read_text())
  curve = json.loads(path.read_text())
  assert set(jax_curve) <= set(curve)
  assert curve['image_size'] == jax_curve['image_size']
  assert curve['batch_size'] == jax_curve['batch_size']
  assert curve['steps'] == jax_curve['steps']
  rows = {row['step']: row for row in curve['curve']}
  assert set(STEPS) <= set(rows)
  row_keys = set(jax_curve['curve'][0])
  for step in STEPS:
    assert set(rows[step]) == row_keys
    for key in ('val_psnr', 'train_view_psnr', 'val_ms_ssim', 'train_loss'):
      assert isinstance(rows[step][key], float) and rows[step][key] > 0
  assert curve['card'].startswith('NVIDIA')
  assert curve['power_limit'].endswith(' W')


@pytest.mark.parametrize('path', JAX_INIT_CURVES, ids=lambda p: p.name)
def test_the_jax_init_curves_name_the_committed_init(path):
  """Each names the init it started from by the npz's sha256, and holds an
  eval every 500 steps to 6,000 of the 20,000-step schedules."""
  curve = json.loads(path.read_text())
  assert curve['init'] == 'jax'
  assert curve['init_sha256'] == hashlib.sha256(
      JAX_INIT_NPZ.read_bytes()).hexdigest()
  assert curve['partial'] and curve['steps'] == 20000
  assert [row['step'] for row in curve['curve']] == list(
      range(500, 6001, 500))


def test_a_seed_repeats_its_rows_at_a_finer_eval_grain():
  """The port's own init of seed 0 with an eval every 500 steps (the
  evals touch no draw of the steps) repeats the seed-0 curve of evals
  every 2,000 at its rows, bit for bit but the render delta and the
  clock."""
  fine = json.loads((REPO / 'nerfies_tpu_torch' / 'curves' /
                     'quality_curve_h100_own_init_seed0.json').read_text())
  coarse = json.loads(H100_CURVES[0].read_text())
  assert 'init' not in fine and 'init' not in coarse
  assert [row['step'] for row in fine['curve']] == list(range(500, 6001, 500))
  rows = {row['step']: row for row in fine['curve']}
  for row in coarse['curve']:
    for key in set(row) - {'render_delta', 'wall_s'}:
      assert rows[row['step']][key] == row[key], (row['step'], key)


SPREAD_DIR = REPO / 'nerfies_tpu_torch' / 'curves' / 'spread'


def _spread_curve(values, steps=(500, 1000)):
  return {'curve': [{'step': step, 'val_psnr': v, 'train_view_psnr': v,
                     'train_loss': 10 ** -v, 'train_loss_mean': 10 ** -v}
                    for step, v in zip(steps, values)]}


def _run_spread(tmp_path, reference, candidate):
  paths = {}
  for name, curves in (('reference', reference), ('candidate', candidate)):
    paths[name] = []
    for i, curve in enumerate(curves):
      paths[name].append(tmp_path / f'{name}{i}.json')
      paths[name][-1].write_text(json.dumps(curve))
  return compare_quality_curves.main(
      ['--spread', *map(str, paths['reference']),
       '--against', *map(str, paths['candidate'])])


def test_welch_matches_scipy():
  from scipy import stats
  reference, candidate = [30.1, 30.9, 29.7, 30.4], [29.2, 30.0, 29.9]
  row = compare_quality_curves.welch(reference, candidate)
  want = stats.ttest_ind(candidate, reference, equal_var=False)
  assert row['t'] == pytest.approx(float(want.statistic), rel=1e-9)
  assert row['df'] == pytest.approx(float(want.df), rel=1e-9)
  assert row['reference_sd'] == pytest.approx(float(np.std(reference,
                                                           ddof=1)))
  assert row['diff'] == pytest.approx(np.mean(candidate) - np.mean(reference))


def test_spread_sets_that_agree_pass(tmp_path, capsys):
  reference = [_spread_curve([20 + d, 25 + d]) for d in (0.0, 0.4, -0.3)]
  candidate = [_spread_curve([20 + d, 25 + d]) for d in (0.2, -0.1, 0.1)]
  assert _run_spread(tmp_path, reference, candidate) == 0
  out = capsys.readouterr().out
  assert out.count('agrees') == 8 and 'trails' not in out.split('\n', 2)[2]
  assert out.splitlines()[-1] == 'OK'


@pytest.mark.parametrize('worse', ['psnr', 'loss'])
def test_a_spread_set_that_trails_fails(tmp_path, capsys, worse):
  """PSNRs 1 dB lower (or losses 10x higher) at 1000 with an sd of ~0.3
  trail by more than two pooled standard errors; 500 agrees."""
  reference = [_spread_curve([20 + d, 25 + d]) for d in (0.0, 0.4, -0.3)]
  candidate = [_spread_curve([20 + d, 24 + d]) for d in (0.2, -0.1, 0.1)]
  if worse == 'loss':
    for curve in candidate:
      row = curve['curve'][1]
      row['val_psnr'] = row['train_view_psnr'] = row['val_psnr'] + 1.0
  assert _run_spread(tmp_path, reference, candidate) == 1
  lines = capsys.readouterr().out.splitlines()
  trailing = [line.split(' | ')[:2] for line in lines if 'trails' in line
              and line[0].isdigit()]
  want = (['val_psnr', 'train_view_psnr', 'train_loss_mean', 'train_loss']
          if worse == 'psnr' else ['train_loss_mean', 'train_loss'])
  assert trailing == [['1000', metric] for metric in want]
  assert lines[-1] == 'FAIL'


def test_spread_needs_both_sets_and_shared_steps(tmp_path, capsys):
  with pytest.raises(SystemExit):
    compare_quality_curves.main(['--spread', 'a.json'])
  reference = [_spread_curve([20.0], steps=(500,))]
  candidate = [_spread_curve([20.0], steps=(1000,))]
  assert _run_spread(tmp_path, reference, candidate) == 1
  assert 'no step and metric in every curve' in capsys.readouterr().out


@pytest.mark.parametrize('pattern,count', [
    ('spread_jax_cpu_seed*.json', 4), ('spread_torch_cuda_seed*.json', 4),
    ('spread_torch_cpu_seed*.json', 2)])
def test_the_committed_spread_sets(pattern, count):
  """The spread curves of both packages: their seeds, an eval every 500
  steps to 3,000 of the 10,000-step schedule with finite readings, and a
  card's name and power limit on the card's."""
  paths = sorted(SPREAD_DIR.glob(pattern))
  assert len(paths) >= count
  seeds = set()
  for path in paths:
    curve = json.loads(path.read_text())
    seeds.add(curve['seed'])
    assert curve['steps'] == 10000 and curve['batch_size'] == 256
    assert curve['image_size'] == [96, 72]
    assert [row['step'] for row in curve['curve']] == list(
        range(500, 3001, 500))
    for row in curve['curve']:
      for key in ('val_psnr', 'train_view_psnr', 'train_loss',
                  'train_loss_mean'):
        assert np.isfinite(row[key]) and row[key] > 0
    if 'cuda' in pattern:
      assert curve['card'].startswith('NVIDIA')
      assert curve['power_limit'].endswith(' W')
  assert len(seeds) == len(paths)
