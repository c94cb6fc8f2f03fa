"""One training step of the quality bench's model at its full width, in
the port and in the JAX package, on the CPU.

Every other step parity test runs a small or narrow model. This one runs
the bench model uncut: a NeRF of 8x256 with the skip at 4, an rgb branch
of 128 with 285 inputs to `rgb_hidden_0`, an SE(3) warp of 6x128 with 6
frequencies, and 128 + 128 samples. Both packages start from JAX's
PRNGKey(0) tree of scripts/quality_bench.py (the committed
nerfies_tpu_torch/curves/init/quality_init_jax_key0.npz, which
tests/test_torch_quality_init.py holds to JAX's init bit for bit) with
fresh Adam moments. The batch is 24 rays and 24 background points of the
quality scene (its layout and ids; the frames cut to 48x36), with the
quality bench's train config: elastic `log_svals` reduced by `weight`
over dense coarse Jacobians and the background loss. Two points of the
20,000-step schedules: step 6,000 (warp alpha 1.8), where the port trails
JAX's curve, and step 2,000 (warp alpha 0.6), where it leads. Every draw
is handed across (tests/torch_step_parity.py).

The plain route runs in float32 (TF32 plays no part on the CPU) at
test_plain_route_step_matches_jax's limits: stats rtol 1e-4, and per leaf
a gradient and an Adam update at cosine >= 0.9999 and norm ratio 1 +-
1e-3. The fused route runs in bf16, JAX's Pallas kernels in interpret
mode, at tests/test_fused_train.py's limits.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest

from nerfies_tpu_torch import datasets
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import quality_bench
from nerfies_tpu_torch import schedules
from nerfies_tpu_torch.datasets import synthetic
from tests import torch_step_parity
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

INIT = (pathlib.Path(__file__).resolve().parent.parent / 'nerfies_tpu_torch'
        / 'curves' / 'init' / 'quality_init_jax_key0.npz')
# scripts/quality_bench.py's scene, its frames cut to 48x36.
SCENE = dict(num_train=24, num_val=2, image_size=(48, 36),
             motion_amplitude=0.15, texture_frequency=20.0,
             cameras_per_state=2, env_background=True, num_points=16384)
RAYS = POINTS = 24
SCHEDULE_STEPS = 20000


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
  """The quality scene's source, its first ray batch and background
  points (numpy, as the bench's iterators give them)."""
  path = tmp_path_factory.mktemp('full_width') / 'scene'
  synthetic.write_synthetic_dataset(path, **SCENE)
  source = datasets.from_config(
      {'type': 'nerfies', 'data_dir': str(path)}, image_scale=1,
      use_appearance_id=True, use_camera_id=True, use_warp_id=True,
      random_seed=0)
  batch = next(source.create_iterator(source.train_ids, flatten=True,
                                      shuffle=True, batch_size=RAYS,
                                      prefetch_size=0))
  batch['background_points'] = source.load_points(shuffle=True)[:POINTS]
  return source, batch


def _config(route):
  """The bench model with rgb padding 0.001: the fused kernels in bf16,
  or the plain forward in float32."""
  config = quality_bench.model_config(fused=route == 'fused')
  if route == 'plain':
    config = dataclasses.replace(config, use_bfloat16=False)
  return config


def test_the_model_is_the_full_width_bench_model(scene):
  source, _ = scene
  config = _config('fused')
  assert (config.nerf_trunk_depth, config.nerf_trunk_width,
          tuple(config.nerf_skips)) == (8, 256, (4,))
  assert (config.nerf_rgb_branch_depth, config.nerf_rgb_branch_width) == (
      1, 128)
  assert (config.num_coarse_samples, config.num_fine_samples) == (128, 128)
  assert (config.warp_field_type, config.num_warp_freqs) == ('se3', 6)
  params = interop.load_npz_tree(INIT)
  mlp = params['nerf_mlps_coarse']
  assert mlp['trunk_hidden_1']['kernel'].shape == (256, 256)
  assert mlp['trunk_hidden_4']['kernel'].shape == (307, 256)
  assert mlp['rgb_hidden_0']['kernel'].shape == (285, 128)
  trunk = params['warp_field']['trunk']
  assert sorted(trunk) == [f'hidden_{i}' for i in range(6)]
  assert trunk['hidden_1']['kernel'].shape == (128, 128)
  # The scene's ids are the init's.
  assert params['appearance_encoder']['embed']['embedding'].shape[0] == len(
      source.appearance_ids)
  assert params['warp_field']['metadata_encoder']['embed'][
      'embedding'].shape[0] == len(source.warp_ids)


@pytest.mark.parametrize('route', ['plain', 'fused'])
@pytest.mark.parametrize('step', [6000, 2000])
def test_full_width_step_matches_jax(scene, route, step):
  """A step at `step` of the schedules from JAX's full-width init: the
  stats and the gradient from fresh Adam moments; the Adam update from a
  mid-run state (count step - 1, mu zero, nu each leaf's mean square of
  JAX's gradient in every element). A fresh Adam's update is lr * g /
  (|g| + eps), the sign of each element of g, so an element whose
  gradient lies within rounding of zero would flip it."""
  source, batch = scene
  ids = dict(appearance_ids=source.appearance_ids,
             camera_ids=source.camera_ids, warp_ids=source.warp_ids,
             near=source.near, far=source.far)
  config = _config(route)
  lr = schedules.from_config(('exponential', 1e-3, 1e-4, SCHEDULE_STEPS))
  warp_alpha = schedules.from_config(
      ('linear', 0.0, config.num_warp_freqs, SCHEDULE_STEPS))(step)
  assert warp_alpha == pytest.approx({6000: 1.8, 2000: 0.6}[step])
  scalars = dict(learning_rate=float(lr(step)), elastic_loss_weight=1e-3,
                 background_loss_weight=1.0)
  both = torch_step_parity.step_pair(
      config, ids, interop.load_npz_tree(INIT), batch, scalars,
      warp_alpha=float(warp_alpha))
  fresh = both()
  assert fresh.fused_route == (route == 'fused')
  assert np.isfinite(list(fresh.jax_stats.values())).all()
  torch_step_parity.check_step(fresh, route, update=False)
  nu = jax.tree.map(
      lambda g: np.full(g.shape, np.mean(np.square(g)), np.float32),
      fresh.jax_grad)
  torch_step_parity.check_step(both(step - 1, None, nu), route)
