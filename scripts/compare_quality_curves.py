#!/usr/bin/env python3
"""Compares a quality curve with a reference curve, step by step.

Both files are quality bench curves (`python -m
nerfies_tpu_torch.quality_bench --out ...` or scripts/quality_bench.py):

  python3 scripts/compare_quality_curves.py docs/quality_curve.json \\
      nerfies_tpu_torch/curves/quality_curve_h100.json --steps 2000 4000 6000

For each step that both curves reached it prints the candidate's val
PSNR, train-view PSNR and val MS-SSIM less the reference's, and its train
loss over the reference's. The bar, at each such step: neither PSNR more
than 1.0 dB below the reference's, MS-SSIM no more than 0.005 below, train
loss no more than 1.5 times the reference's. A metric that either curve
lacks (null) misses the bar. With --steps, each step named must be in
both curves. Exits 0 when every compared row meets the bar, 1 otherwise
(a row outside it, a step missing, or no step shared).

Two sets of curves, one a seed each (scripts/training_spread_*.py):

  python3 scripts/compare_quality_curves.py \
      --spread nerfies_tpu_torch/curves/spread/spread_jax_cpu_seed*.json \
      --against nerfies_tpu_torch/curves/spread/spread_torch_cuda_seed*.json

For each step that every curve reached and each metric of SPREAD_METRICS
that they all hold, it prints each set's mean and sample standard
deviation, the candidate's mean less the reference's, Welch's t of that
difference (over the pooled standard error sqrt(sd_a^2 / n_a + sd_b^2 /
n_b)) and its degrees of freedom. A row where the candidate is worse by
more than GAP_SE pooled standard errors (PSNR lower, loss higher) reads
`trails`; exits 1 when any row trails, 0 otherwise. Imports no JAX.
"""

import argparse
import json
import math
import pathlib
import sys
from typing import List, Optional, Sequence

PSNR_DROP_DB = 1.0
MS_SSIM_DROP = 0.005
LOSS_RATIO = 1.5
# The metrics of a spread comparison, each with the sign of "better".
SPREAD_METRICS = (('val_psnr', 1), ('train_view_psnr', 1),
                  ('train_loss_mean', -1), ('train_loss', -1))
GAP_SE = 2.0


def load_curve(path) -> dict:
  """The curve's rows by step."""
  rows = json.loads(pathlib.Path(path).read_text())['curve']
  return {row['step']: row for row in rows}


def _difference(candidate, reference):
  if candidate is None or reference is None:
    return None
  return candidate - reference


def compare_row(reference: dict, candidate: dict) -> dict:
  """The differences of one step and the metrics that miss the bar."""
  row = {
      'step': reference['step'],
      'd_val_psnr': _difference(candidate.get('val_psnr'),
                                reference.get('val_psnr')),
      'd_train_view_psnr': _difference(candidate.get('train_view_psnr'),
                                       reference.get('train_view_psnr')),
      'd_val_ms_ssim': _difference(candidate.get('val_ms_ssim'),
                                   reference.get('val_ms_ssim')),
      'loss_ratio': (candidate['train_loss'] / reference['train_loss']
                     if candidate.get('train_loss') is not None
                     and reference.get('train_loss') else None),
  }
  misses = [key for key, floor in (('d_val_psnr', -PSNR_DROP_DB),
                                   ('d_train_view_psnr', -PSNR_DROP_DB),
                                   ('d_val_ms_ssim', -MS_SSIM_DROP))
            if row[key] is None or row[key] < floor]
  if row['loss_ratio'] is None or row['loss_ratio'] > LOSS_RATIO:
    misses.append('loss_ratio')
  row['misses'] = misses
  return row


def compare(reference: dict, candidate: dict,
            steps: Sequence[int] = ()) -> List[dict]:
  """One row a shared step, and a row with `missing` for each of `steps`
  that a curve lacks."""
  rows = [compare_row(reference[step], candidate[step])
          for step in sorted(set(reference) & set(candidate))]
  for step in steps:
    if step not in reference or step not in candidate:
      rows.append({'step': step, 'missing': [
          name for name, curve in (('reference', reference),
                                   ('candidate', candidate))
          if step not in curve]})
  return sorted(rows, key=lambda row: row['step'])


def _format(value: Optional[float], spec: str) -> str:
  return 'n/a' if value is None else format(value, spec)


def mean_sd(values: Sequence[float]):
  """The mean and the sample standard deviation (0 for one value)."""
  n = len(values)
  mean = sum(values) / n
  var = sum((v - mean) ** 2 for v in values) / (n - 1) if n > 1 else 0.0
  return mean, math.sqrt(var)


def welch(reference: Sequence[float], candidate: Sequence[float]) -> dict:
  """The two sets' means and sds, the candidate's mean less the
  reference's, its pooled standard error, Welch's t and the
  Welch-Satterthwaite degrees of freedom (t and df None where the
  standard error is 0)."""
  (ma, sa), (mb, sb) = mean_sd(reference), mean_sd(candidate)
  na, nb = len(reference), len(candidate)
  va, vb = sa * sa / na, sb * sb / nb
  se = math.sqrt(va + vb)
  row = {'reference_mean': ma, 'reference_sd': sa, 'reference_n': na,
         'candidate_mean': mb, 'candidate_sd': sb, 'candidate_n': nb,
         'diff': mb - ma, 'se': se, 't': None, 'df': None}
  if se > 0:
    row['t'] = (mb - ma) / se
    terms = ((va * va / (na - 1) if na > 1 else 0.0)
             + (vb * vb / (nb - 1) if nb > 1 else 0.0))
    row['df'] = (va + vb) ** 2 / terms if terms else None
  return row


def compare_spread(reference: Sequence[dict],
                   candidate: Sequence[dict]) -> List[dict]:
  """One row a step that every curve of both sets holds and a metric
  they all hold: welch() of the metric's values, and `trails` where the
  candidate is worse by more than GAP_SE pooled standard errors."""
  curves = list(reference) + list(candidate)
  steps = sorted(set.intersection(*(set(c) for c in curves)))
  rows = []
  for step in steps:
    for metric, better in SPREAD_METRICS:
      values = [c[step].get(metric) for c in curves]
      if any(v is None for v in values):
        continue
      row = welch(values[:len(reference)], values[len(reference):])
      row.update(step=step, metric=metric,
                 trails=row['t'] is not None and better * row['t'] < -GAP_SE)
      rows.append(row)
  return rows


def main_spread(reference_paths: Sequence[str],
                candidate_paths: Sequence[str]) -> int:
  rows = compare_spread([load_curve(p) for p in reference_paths],
                        [load_curve(p) for p in candidate_paths])
  print(f'reference: {len(reference_paths)} curves; candidate: '
        f'{len(candidate_paths)} curves; trails: worse by more than '
        f'{GAP_SE} pooled standard errors')
  print('step | metric | reference mean +- sd | candidate mean +- sd | '
        'difference | Welch t | df | verdict')
  for row in rows:
    spec = '.5f' if 'psnr' in row['metric'] else '.4e'
    print(f"{row['step']} | {row['metric']} | "
          f"{format(row['reference_mean'], spec)} +- "
          f"{format(row['reference_sd'], spec)} | "
          f"{format(row['candidate_mean'], spec)} +- "
          f"{format(row['candidate_sd'], spec)} | "
          f"{format(row['diff'], '+' + spec)} | {_format(row['t'], '+.3f')} | "
          f"{_format(row['df'], '.1f')} | "
          f"{'trails' if row['trails'] else 'agrees'}")
  if not rows:
    print('no step and metric in every curve')
  failed = not rows or any(row['trails'] for row in rows)
  print('FAIL' if failed else 'OK')
  return 1 if failed else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      description='Compares a quality curve with a reference curve.')
  parser.add_argument('reference', nargs='?',
                      help='the reference curve (JSON)')
  parser.add_argument('candidate', nargs='?',
                      help='the curve held to it (JSON)')
  parser.add_argument('--steps', type=int, nargs='*', default=(),
                      help='steps that both curves must hold')
  parser.add_argument('--spread', nargs='+', default=(),
                      help='a reference set of curves, one a seed')
  parser.add_argument('--against', nargs='+', default=(),
                      help='the candidate set of curves held to --spread')
  args = parser.parse_args(argv)
  if args.spread or args.against:
    if not (args.spread and args.against) or args.reference:
      parser.error('--spread and --against go together, without the '
                   'positional curves')
    return main_spread(args.spread, args.against)
  if not args.candidate:
    parser.error('a reference and a candidate curve are needed')
  rows = compare(load_curve(args.reference), load_curve(args.candidate),
                 args.steps)
  print(f'bar: PSNR >= -{PSNR_DROP_DB} dB, MS-SSIM >= -{MS_SSIM_DROP}, '
        f'train loss <= {LOSS_RATIO}x the reference')
  print('step | d val PSNR dB | d train-view PSNR dB | d val MS-SSIM | '
        'train loss ratio | verdict')
  failed = not rows
  for row in rows:
    if 'missing' in row:
      failed = True
      print(f"{row['step']} | missing from the "
            f"{' and '.join(row['missing'])}")
      continue
    failed = failed or bool(row['misses'])
    verdict = ('meets the bar' if not row['misses']
               else 'misses: ' + ', '.join(row['misses']))
    print(f"{row['step']} | {_format(row['d_val_psnr'], '+.5f')} | "
          f"{_format(row['d_train_view_psnr'], '+.5f')} | "
          f"{_format(row['d_val_ms_ssim'], '+.6f')} | "
          f"{_format(row['loss_ratio'], '.4f')} | {verdict}")
  if not rows:
    print('no step in both curves')
  print('FAIL' if failed else 'OK')
  return 1 if failed else 0


if __name__ == '__main__':
  sys.exit(main())
