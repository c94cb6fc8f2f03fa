"""scripts/compare_quality_curves.py on made-up curves, and the form of the
port's committed H100 quality curve (its rows are not held to the bar
here: that is a reading of the card, not of this checkout). Imports no
JAX."""

import copy
import importlib.util
import json
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_CURVE = REPO / 'docs' / 'quality_curve.json'
# The fused route's 6,000-step curves of an H100 (seeds 0 and 1).
H100_CURVES = [REPO / 'nerfies_tpu_torch' / 'curves' / name for name in (
    'quality_curve_h100.json', 'quality_curve_h100_fused_seed1.json')]
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


@pytest.mark.parametrize('path', H100_CURVES, ids=lambda p: p.name)
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
