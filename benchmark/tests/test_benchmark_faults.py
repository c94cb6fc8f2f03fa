"""`correct` comes out false for the control and for each fault a cell can
have, with the rest of a run driven as on the card (here on the CPU at the
size of bench_tiny): a step that returns its state unchanged; half of each
batch left out, the mean taken over the rest; rows that the input pipeline
pairs wrongly; a rendered answer altered where it is produced. One chip
holds no exchange between chips to leave out. The control, the reference in fp8 put in the program's place, is
read on the card at the cells' sizes by calibrate.py; here at test size."""

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark import cells
from benchmark import compare
from benchmark import run
from benchmark.tests import bench_tiny

SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def _few_threads():
  torch.set_num_threads(2)


def _run(workload):
  return run.run(bench_tiny.tiny_cell(workload), SEED, 0.3, False,
                 device='cpu', say=lambda line: None)


def test_a_sound_run_is_correct():
  assert _run('vrig_paper.train')['correct'] is True


def test_a_state_left_unchanged_is_not_correct(monkeypatch):
  from nerfies_tpu_torch import training
  original = training.make_train_step

  def make(*args, **kwargs):
    step = original(*args, **kwargs)

    def unchanged(generator, state, batch, scalars, **kw):
      _, stats = step(generator, state, batch, scalars, **kw)
      return state, stats

    return unchanged

  monkeypatch.setattr(training, 'make_train_step', make)
  result = _run('vrig_paper.train')
  assert result['correct'] is False
  assert result['checked']['update_gap']['value'] == pytest.approx(1.0)


def _train_kind():
  cell = bench_tiny.tiny_cell('vrig_paper.train')
  return cells.kind(cell.traffic['kind'], cell)


def test_half_of_each_batch_left_out_is_not_correct():
  undo = _train_kind().half_batch_steps()
  try:
    result = _run('vrig_paper.train')
  finally:
    undo()
  assert result['correct'] is False


def test_rows_the_pipeline_pairs_wrongly_are_not_correct():
  undo = _train_kind().misrouted_rows()
  try:
    result = _run('vrig_paper.train')
  finally:
    undo()
  assert result['correct'] is False
  assert result['checked']['rows_off']['value'] > 0


@pytest.mark.parametrize('field', ['origins', 'warp', 'background_points'])
def test_a_row_that_is_no_pixel_of_the_capture_is_counted(field):
  from benchmark import scene
  cell = bench_tiny.tiny_cell('vrig_paper.train')
  ids = cells.num_ids(cell)
  capture = scene.capture(cell.traffic, cell.config['scene'], ids, SEED)
  pick = np.asarray([5, 700, 1500])
  frame = capture.image_idx[pick]
  batch = {'directions': capture.directions[pick],
           'rgb': capture.rgb[pick].astype(np.float32) / 255.0,
           'origins': capture.origins[frame].copy(),
           'metadata': {k: v[frame].copy() for k, v in
                        capture.metadata.items()},
           'background_points': capture.points[:4].copy()}
  assert compare.rows_off([batch], capture) == 0
  if field == 'warp':
    batch['metadata']['warp'][1] += 1
  elif field == 'origins':
    batch['origins'][2, 0] += 1e-3
  else:
    batch['background_points'][3] = batch['background_points'][0]
  assert compare.rows_off([batch], capture) == 1


def test_an_altered_frame_is_not_correct(monkeypatch):
  from nerfies_tpu_torch import evaluation
  original = evaluation.render_camera

  def altered(*args, **kwargs):
    out = original(*args, **kwargs)
    out['rgb'] = out['rgb'] + 0.05
    return out

  monkeypatch.setattr(evaluation, 'render_camera', altered)
  assert _run('vrig_paper.render')['correct'] is False


@pytest.mark.parametrize('workload', ['vrig_paper.train', 'fullhd.train',
                                      'vrig_paper.render'])
def test_the_control_is_not_correct(workload):
  cell = bench_tiny.tiny_cell(workload)
  readings = dict(calibrate.readings(cell, SEED, True, 'cpu', 0.3))
  assert compare.judge(readings['program'], cell.limits['numbers'])[0]
  assert not compare.judge(readings['control'], cell.limits['numbers'])[0]
