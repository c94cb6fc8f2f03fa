"""The port's program spans (utils.span) on the CPU.

A tiny train step fed by the prefetching iterators, and a tiny frame
through `render_camera` and `render_image`, run under torch.profiler with
CPU activity; their Chrome traces must hold every span at its place: each
phase inside its unit span (`train.step`, `render.frame`), `kernel.pack`
inside the forward, the backward and the render's model call. With the
profiler off no span is opened at all. Imports no JAX.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nerfies_tpu_torch import camera
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import evaluation
from nerfies_tpu_torch import training
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.datasets import core
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.parallel import mesh
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(
    num_coarse_samples=4, num_fine_samples=4, nerf_trunk_depth=3,
    nerf_trunk_width=32, nerf_rgb_branch_depth=1, nerf_rgb_branch_width=16,
    nerf_skips=(2,), num_nerf_point_freqs=3, num_nerf_viewdir_freqs=2,
    num_warp_freqs=2, use_warp=True, warp_field_type='se3',
    warp_kwargs={'trunk_depth': 3, 'skips': (2,)},
    use_appearance_metadata=True, use_alpha_condition=True,
    use_rgb_condition=True, sigma_activation='softplus',
    use_stratified_sampling=False, noise_std=None, use_bfloat16=True,
    use_fused_mlp=True)
IDS = dict(appearance_ids=(0, 1), camera_ids=(0,), warp_ids=(0, 1),
           near=0.5, far=3.0)
TRAIN = configs.TrainConfig(
    batch_size=8, use_elastic_loss=True, elastic_reduce_method='weight',
    use_background_loss=True, background_points_batch_size=8)
SCALARS = training.ScalarParams(learning_rate=1e-2, elastic_loss_weight=0.01,
                                background_loss_weight=1.0)
TRAIN_SPANS = {'data.wait', 'train.step', 'train.to_device', 'train.forward',
               'train.loss', 'train.backward', 'train.optimizer',
               'kernel.pack'}
RENDER_SPANS = {'render.frame', 'render.rays', 'render.model',
                'render.gather', 'kernel.pack'}


def _model():
  return nerf.construct_nerf(configs.ModelConfig(**TINY), **IDS,
                             generator=torch.Generator().manual_seed(0),
                             device='cpu', use_warp_jacobian=True,
                             use_weights=True)


def _iterators(seed=0, rays=64):
  rng = np.random.RandomState(seed)
  directions = rng.normal(size=(rays, 3)).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  ids = lambda high: rng.randint(0, high, (rays, 1)).astype(np.int64)
  arrays = {'origins': np.zeros((rays, 3), np.float32),
            'directions': directions,
            'rgb': rng.uniform(size=(rays, 3)).astype(np.float32),
            'metadata': {'warp': ids(2), 'appearance': ids(2),
                         'camera': ids(1)}}
  points = rng.normal(size=(rays, 3)).astype(np.float32)
  return (core.iterator_from_arrays(arrays, TRAIN.batch_size, seed=seed,
                                    prefetch_size=2),
          core.iterator_from_arrays(points, TRAIN.background_points_batch_size,
                                    seed=seed, prefetch_size=2))


def _train(model, params, steps=1):
  """Runs `steps` train steps, each on the iterators' next batch."""
  step = training.make_train_step(model, TRAIN, device='cpu')
  state = training.create_train_state(params, warp_alpha=1.5)
  rays, points = _iterators()
  for _ in range(steps):
    batch = next(rays)
    batch['background_points'] = next(points)
    state, _ = step(None, state, batch, SCALARS)
  return state


def _camera(h=5, w=7):
  return camera.Camera(orientation=np.eye(3), position=np.zeros(3),
                       focal_length=6.0, principal_point=np.array([3.5, 2.5]),
                       image_size=np.array([w, h]))


def _render(model, params):
  """One frame through render_camera, one through render_image."""
  fn = evaluation.make_render_fn(model, device='cpu')
  assert fn.fast
  state = evaluation.RenderState(params, warp_alpha=1.5)
  ids = {'warp': 1, 'appearance': 0, 'camera': 0}
  evaluation.render_camera(state, _camera(), ids, fn, chunk=16)
  rng = np.random.RandomState(1)
  directions = rng.normal(size=(5, 7, 3)).astype(np.float32)
  meta = np.zeros((5, 7, 1), np.int64)
  rays = {'origins': np.zeros((5, 7, 3), np.float32),
          'directions': directions / np.linalg.norm(directions, axis=-1,
                                                    keepdims=True),
          'metadata': {'warp': meta, 'appearance': meta, 'camera': meta}}
  evaluation.render_image(state, rays, fn, chunk=16)


def _spans(fn, tmp_path):
  """[(name, tid, start, end)] of the user annotations of `fn`'s trace."""
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    fn()
  path = tmp_path / 'trace.json'
  prof.export_chrome_trace(str(path))
  events = json.loads(path.read_text())
  events = events['traceEvents'] if isinstance(events, dict) else events
  return [(e['name'], e['tid'], float(e['ts']), float(e['ts']) + e['dur'])
          for e in events if e.get('cat') == 'user_annotation']


def _inside(span, outer_name, spans):
  """Whether `span` lies within a span named `outer_name` of its thread."""
  name, tid, start, end = span
  return any(o[0] == outer_name and o[1] == tid and o[2] <= start
             and end <= o[3] and o is not span for o in spans)


@pytest.mark.parametrize('world', [1, 2])
def test_a_train_step_opens_every_span_in_its_place(tmp_path, monkeypatch,
                                                    world):
  if world > 1:
    # Two ranks' step without a group: this rank's draws, and the
    # all-reduce of the gradients and stats as the identity.
    monkeypatch.setattr(mesh, 'world_size', lambda: world)
    monkeypatch.setattr(mesh, 'all_reduce_mean', list)
  model, params = _model()
  spans = _spans(lambda: _train(model, params, steps=2), tmp_path)
  names = {s[0] for s in spans}
  want = TRAIN_SPANS | ({'train.all_reduce'} if world > 1 else set())
  assert names == want
  assert sum(s[0] == 'train.step' for s in spans) == 2
  for span in spans:
    if span[0] == 'data.wait':
      assert not _inside(span, 'train.step', spans)
    else:
      assert span[0] == 'train.step' or _inside(span, 'train.step', spans)
  packs = [s for s in spans if s[0] == 'kernel.pack']
  for phase in ('train.forward', 'train.backward', 'train.loss'):
    # The background loss applies the fused warp again.
    assert any(_inside(s, phase, spans) for s in packs), phase
  assert all(any(_inside(s, phase, spans) for phase in (
      'train.forward', 'train.backward', 'train.loss')) for s in packs)


def test_a_frame_opens_every_span_in_its_place(tmp_path):
  model, params = _model()
  spans = _spans(lambda: _render(model, params), tmp_path)
  assert {s[0] for s in spans} == RENDER_SPANS
  assert sum(s[0] == 'render.frame' for s in spans) == 2
  # 35 pixels in chunks of 16: three chunks a frame, each with its rays
  # and model call; render_camera uploads the camera once more.
  count = lambda name: sum(s[0] == name for s in spans)
  assert count('render.model') == 6 and count('render.rays') == 7
  assert count('render.gather') == 2
  for span in spans:
    assert span[0] == 'render.frame' or _inside(span, 'render.frame', spans)
    if span[0] == 'kernel.pack':
      assert _inside(span, 'render.model', spans)


def test_each_wait_for_a_batch_is_one_data_wait_span(tmp_path):
  """The prefetching iterator's consumer opens `data.wait` once for each
  batch asked of it, on the thread that asks."""
  rays, _ = _iterators()
  next(rays)
  spans = _spans(lambda: [next(rays) for _ in range(3)], tmp_path)
  assert [s[0] for s in spans] == ['data.wait'] * 3
  assert len({s[1] for s in spans}) == 1


def test_with_the_profiler_off_no_span_is_opened(monkeypatch):
  def refuse(name):
    raise AssertionError(f'record_function({name!r}) with no profiler on')

  monkeypatch.setattr(torch.profiler, 'record_function', refuse)
  monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
  assert utils.span('train.step') is utils.span('render.frame')
  model, params = _model()
  state = _train(model, params, steps=2)
  assert state.step == 2
  _render(model, params)


def test_a_span_is_the_profilers_range_only_while_it_records():
  assert not isinstance(utils.span('x'), torch.profiler.record_function)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    assert isinstance(utils.span('x'), torch.profiler.record_function)

  @utils.spanned('train.optimizer')
  def adam(a, b=2):
    """Doc."""
    return a + b

  assert adam(1, b=3) == 4 and adam.__doc__ == 'Doc.'
  assert training.adam_update.__name__ == 'adam_update'
