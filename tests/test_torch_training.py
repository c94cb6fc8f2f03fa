"""The port's training step against the JAX package's, on the CPU.

The JAX step runs its fused path with the Pallas kernels in interpret
mode (nerfies_tpu/training.py picks it off-TPU); the port runs the plain
versions of its kernels (CPU tensors). Small shapes of
tests/test_fused_train.py, deterministic sampling, noise_std None. Random
draws cannot be matched across frameworks, so the background loss's
warp ids and noise are drawn with JAX's own key schedule and handed to the
port. Tolerances: stats rtol 0.05, atol 5e-4 and gradients by cosine >
0.95 and norm ratio in (0.7, 1.4) (tests/test_fused_train.py); float32
losses and Adam at 1e-5 and 1e-6.
"""

import dataclasses
from unittest import mock

import jax
from jax import random
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfies_tpu import training as jax_training
from nerfies_tpu.ops import rigid as jax_rigid
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import fused_train
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import training
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import fused_warp
from nerfies_tpu_torch.ops import rigid
from tests.test_fused_train import _batch
from tests.test_fused_train import _build
from tests.torch_parity import grad_check
from tests.torch_parity import model_pair
from tests.torch_parity import port_model
from tests.torch_parity import ray_batch

_WARP_ALPHA = 1.5
_LOSS_TYPES = ['log_svals', 'svals', 'jtj', 'div', 'det', 'log_det', 'nr']


def _jacobians(seed=0, shape=(5, 7)):
  rng = np.random.RandomState(seed)
  j = (np.eye(3, dtype=np.float32).reshape(3, 3, 1, 1)
       + 0.2 * rng.normal(size=(3, 3) + shape)).astype(np.float32)
  j[0, :, 0] *= -1.0  # some reflections
  return j


@pytest.mark.parametrize('loss_type', _LOSS_TYPES)
def test_elastic_loss_matches(loss_type):
  j = _jacobians()
  (want_loss, want_res), vjp = jax.vjp(
      lambda a: jax_training.compute_elastic_loss(a, loss_type=loss_type),
      jnp.asarray(j))
  want_grad, = vjp((jnp.ones_like(want_loss), jnp.zeros_like(want_res)))
  tj = torch.from_numpy(j).requires_grad_(True)
  loss, res = training.compute_elastic_loss(tj, loss_type=loss_type)
  grad, = torch.autograd.grad(loss.sum(), tj)
  np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                             atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(res.detach().numpy(), np.asarray(want_res),
                             atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-5,
                             rtol=1e-4)


@pytest.mark.parametrize('jouts_scale', [0.0, 1e-3])
def test_elastic_grad_at_the_identity_warp(jouts_scale):
  """The log_svals loss of the linearized SE(3) Jacobian at w = 0, the
  identity rotation (init-scale heads), differentiated to w, v and the
  trunk's jouts: finite, and equal to JAX's."""
  rng = np.random.RandomState(1)
  n = 12
  w = np.zeros((n, 3), np.float32)
  v = (1e-4 * rng.normal(size=(n, 3))).astype(np.float32)
  p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
  jw = (jouts_scale * rng.normal(size=(3, n, 3))).astype(np.float32)
  jv = (jouts_scale * rng.normal(size=(3, n, 3))).astype(np.float32)
  eye = np.eye(3, dtype=np.float32)

  def jax_loss(w, v, jw, jv):
    _, lin = jax.linearize(jax_rigid.se3_apply_raw, w, v, jnp.asarray(p))
    cols = [lin(jw[j], jv[j], jnp.broadcast_to(eye[j], p.shape))
            for j in range(3)]
    jac = jnp.stack([jnp.stack([cols[j][..., i] for j in range(3)])
                     for i in range(3)])
    return jax_training.compute_elastic_loss(jac)[0].sum()

  want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
      *map(jnp.asarray, (w, v, jw, jv)))
  tw, tv, tjw, tjv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (w, v, jw, jv))
  cols = [torch.func.jvp(rigid.se3_apply_raw, (tw, tv, torch.from_numpy(p)),
                         (tjw[j], tjv[j], torch.from_numpy(eye[j]).expand(
                             n, 3)))[1] for j in range(3)]
  loss = training.compute_elastic_loss(fused_train._stack_jacobian(cols))[0]
  got = torch.autograd.grad(loss.sum(), (tw, tv, tjw, tjv))
  for g, w_ in zip(got, want):
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5,
                               rtol=1e-5)


def _jax_background_draws(model, key, num_points):
  """The warp ids and unit noise JAX's compute_background_loss draws."""
  choice_key, noise_key = random.split(key)
  ids = random.choice(choice_key, jnp.asarray(model.warp_ids, jnp.uint32),
                      shape=(num_points, 1))
  noise = random.normal(noise_key, (num_points, 3))
  return (torch.from_numpy(np.asarray(ids).astype(np.int64)),
          torch.from_numpy(np.array(noise)))


def test_background_loss_matches_jax():
  jmodel, jparams = _build()
  model = port_model()
  points = np.random.RandomState(3).normal(size=(40, 3)).astype(np.float32)
  key = random.PRNGKey(4)
  jstate = jax_training.create_train_state(jparams, warp_alpha=_WARP_ALPHA)
  want = jax_training.compute_background_loss(
      jmodel, jstate, jparams, key, jnp.asarray(points), noise_std=0.001)
  state = training.create_train_state(
      interop.params_from_jax(jparams, device='cpu'), warp_alpha=_WARP_ALPHA)
  got = training.compute_background_loss(
      model, state, state.params, torch.from_numpy(points), 0.001,
      draws=_jax_background_draws(jmodel, key, 40))
  assert got.shape == (40,)
  # The warp tolerance of tests/test_fused_warp.py: rtol 1e-2.
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-2, atol=1e-7)


@pytest.mark.parametrize('reduce_method', ['weight', 'median'])
def test_train_step_matches_jax(reduce_method):
  """Stats and per-leaf gradients of one step, every loss on."""
  jmodel, jparams = _build()
  model = port_model()
  batch = _batch()
  batch['background_points'] = np.random.RandomState(6).normal(
      size=(32, 3)).astype(np.float32)
  scalars = dict(learning_rate=1e-3, elastic_loss_weight=0.01,
                 warp_reg_loss_weight=0.01, background_loss_weight=1.0)
  switches = dict(use_elastic_loss=True, elastic_reduce_method=reduce_method,
                  use_warp_reg_loss=True, use_background_loss=True)
  key = random.PRNGKey(7)
  jstate = jax_training.create_train_state(jparams, warp_alpha=_WARP_ALPHA)
  jnew, jstats, _ = jax_training.train_step(
      jmodel, key, jstate, batch, jax_training.ScalarParams(**scalars),
      **switches)
  reg_key = random.split(key, 4)[3]
  draws = _jax_background_draws(jmodel, reg_key, 32)

  train_config = configs.TrainConfig(batch_size=12, **switches)
  step = training.make_train_step(model, train_config, device='cpu')
  state = training.create_train_state(
      interop.params_from_jax(jparams, device='cpu'), warp_alpha=_WARP_ALPHA)
  new_state, stats = step(None, state, batch,
                          training.ScalarParams(**scalars), draws)

  want = {'/'.join(k.key for k in path): float(v) for path, v in
          jax.tree_util.tree_flatten_with_path(jstats)[0]}
  got = {'/'.join(path): float(v)
         for path, v in fused_mlp.flatten_tree(stats)}
  assert set(got) == set(want)
  for name, value in want.items():
    np.testing.assert_allclose(got[name], value, rtol=0.05, atol=5e-4,
                               err_msg=name)
  # From zero moments, the first Adam moment is 0.1 x the gradient.
  grad_check(new_state.opt_state.mu, jnew.opt_state.mu, 'gradient')
  assert new_state.step == 1 and new_state.opt_state.count == 1
  moved = [not torch.equal(a, b) for (_, a), (_, b) in zip(
      fused_mlp.flatten_tree(new_state.params),
      fused_mlp.flatten_tree(state.params))]
  assert sum(moved) > len(moved) // 2


def test_adam_step_from_a_jax_state_matches_optax():
  """train_state_from_jax carries params and a non-zero Adam state over;
  one more update equals optax.scale_by_adam followed by -lr."""
  rng = np.random.RandomState(8)
  params = {'a': {'kernel': rng.normal(size=(4, 3)).astype(np.float32),
                  'bias': rng.normal(size=(3,)).astype(np.float32)},
            'b': rng.normal(size=(5,)).astype(np.float32)}
  tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
  grads = [jax.tree.map(lambda p: jnp.asarray(
      rng.normal(size=p.shape).astype(np.float32)), params) for _ in range(3)]
  opt_state = tx.init(params)
  for g in grads[:2]:
    _, opt_state = tx.update(g, opt_state, params)
  lr = 1e-3
  updates, want_state = tx.update(grads[2], opt_state, params)
  want_params = optax.apply_updates(
      params, jax.tree.map(lambda u: -lr * u, updates))

  state = interop.train_state_from_jax(params, opt_state, step=2,
                                       device='cpu')
  assert state.opt_state.count == 2
  tgrads = training._map(lambda g: torch.from_numpy(np.asarray(g)), grads[2])
  new_params, new_opt = training.adam_update(tgrads, state.opt_state,
                                             state.params, lr)
  assert new_opt.count == 3
  for tree, want_tree in ((new_params, want_params),
                          (new_opt.mu, want_state.mu),
                          (new_opt.nu, want_state.nu)):
    for path, t in fused_mlp.flatten_tree(tree):
      want = want_tree
      for key in path:
        want = want[key]
      np.testing.assert_allclose(t.detach().numpy(), np.asarray(want),
                                 atol=1e-6, rtol=1e-6, err_msg=str(path))
  assert all(t.requires_grad for _, t in fused_mlp.flatten_tree(new_params))


def test_train_entry_points_need_a_card_unless_told_cpu():
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is valid')
  model = port_model()
  config = configs.TrainConfig(batch_size=4)
  with pytest.raises(RuntimeError, match='device="cpu"'):
    training.make_train_step(model, config)
  with pytest.raises(RuntimeError, match='device="cpu"'):
    interop.train_state_from_jax({'w': np.zeros(2)},
                                 {'count': 0, 'mu': {'w': np.zeros(2)},
                                  'nu': {'w': np.zeros(2)}})
  training.make_train_step(model, config, device='cpu')


def test_bench_train_config_is_the_bench_workload():
  model, train = configs.bench_train_config()
  assert model.use_stratified_sampling
  assert dataclasses.replace(model, use_stratified_sampling=False) == \
      configs.bench_render_config()
  assert (train.batch_size, train.elastic_reduce_method,
          train.elastic_loss_type) == (6144, 'weight', 'log_svals')
  assert train.use_elastic_loss and train.use_background_loss
  assert train.background_points_batch_size == 16384
  assert configs.BENCH_TRAIN_SCALARS == dict(
      learning_rate=1e-3, elastic_loss_weight=1e-3,
      background_loss_weight=1.0)


def _plain_step_pair(reduce_method, gathered, seed=0, **overrides):
  """One step of JAX's train_step through model.apply and of the port's
  plain route, from the same params, rays and background draws, every
  loss on. The model computes dense Jacobians unless `gathered`.

  The warp heads' random params are scaled by 0.1, so that the warp stays
  mild and its Jacobians well-conditioned, as a trained field's: at full
  scale a singular value near 1e-3 makes log_svals' float32 value depend
  on summation order, in JAX as in the port.

  Returns (JAX stats, JAX first Adam moment, port stats, port state).
  """
  dense = not gathered
  jmodel, jparams, model, _ = model_pair(
      seed=seed, use_warp_jacobian=dense, use_weights=True,
      use_appearance_metadata=True, use_rgb_condition=True, **overrides)
  assert not model.fused_route
  jparams = jax.tree_util.tree_map_with_path(
      lambda path, leaf: (0.1 * leaf if 'branches' in jax.tree_util.keystr(
          path) else leaf), jparams)
  params = interop.params_from_jax(jparams, device='cpu')
  batch = ray_batch(12, seed=seed)
  rng = np.random.RandomState(seed + 6)
  batch['rgb'] = rng.uniform(size=(12, 3)).astype(np.float32)
  batch['background_points'] = rng.normal(size=(32, 3)).astype(np.float32)
  scalars = dict(learning_rate=1e-3, elastic_loss_weight=0.01,
                 warp_reg_loss_weight=0.01, background_loss_weight=1.0)
  switches = dict(use_elastic_loss=True, elastic_reduce_method=reduce_method,
                  use_warp_reg_loss=True, use_background_loss=True)
  key = random.PRNGKey(7)
  jstate = jax_training.create_train_state(jparams, warp_alpha=_WARP_ALPHA,
                                           time_alpha=0.4)
  jnew, jstats, _ = jax_training.train_step(
      jmodel, key, jstate, jax.tree.map(jnp.asarray, batch),
      jax_training.ScalarParams(**scalars), **switches)
  draws = _jax_background_draws(jmodel, random.split(key, 4)[3], 32)
  step = training.make_train_step(
      model, configs.TrainConfig(batch_size=12, **switches), device='cpu')
  state = training.create_train_state(params, warp_alpha=_WARP_ALPHA,
                                      time_alpha=0.4)
  new_state, stats = step(None, state, batch,
                          training.ScalarParams(**scalars), draws)
  return jstats, jnew.opt_state.mu, stats, new_state


@pytest.mark.parametrize('case', ['weight', 'median_dense',
                                  'median_gathered', 'median_gathered_time'])
def test_plain_route_step_matches_jax(case):
  """The step through NerfModel.forward against JAX's through
  model.apply (use_fused_mlp False): stats at rtol 1e-4, atol 1e-6; each
  gradient leaf at cosine >= 0.9999 and norm ratio within 1 +- 1e-3. The
  gathered median linearizes the plain field at the median points
  (JAX's _median_jacobian), reading metadata['time'] for the time
  encoder."""
  overrides = ({'warp_metadata_encoder_type': 'time'}
               if case.endswith('time') else {})
  jstats, jmu, stats, new_state = _plain_step_pair(
      case.split('_')[0], 'gathered' in case, **overrides)
  want = {'/'.join(k.key for k in path): float(v) for path, v in
          jax.tree_util.tree_flatten_with_path(jstats)[0]}
  got = {'/'.join(path): float(v)
         for path, v in fused_mlp.flatten_tree(stats)}
  assert set(got) == set(want)
  for name, value in want.items():
    np.testing.assert_allclose(got[name], value, rtol=1e-4, atol=1e-6,
                               err_msg=name)
  grad_check(new_state.opt_state.mu, jmu, 'gradient', cos_floor=0.9999,
             ratio=(1 - 1e-3, 1 + 1e-3))


def test_gathered_median_equals_the_dense_median():
  """The elastic loss of the gathered median equals that of the dense
  Jacobians' median column (tests/test_training.py:155-197)."""
  dense = _plain_step_pair('median', gathered=False)[2]
  gathered = _plain_step_pair('median', gathered=True)[2]
  for key in ('loss/elastic', 'residual/elastic', 'loss/rgb'):
    np.testing.assert_allclose(float(gathered['coarse'][key]),
                               float(dense['coarse'][key]), rtol=1e-5,
                               err_msg=key)


def test_fused_route_with_the_plain_warp_matches_jax():
  """use_fused_warp=False inside the fused route: the NeRF kernels' plain
  versions and the plain warp field, against JAX's fused step with the
  Flax warp, at tests/test_fused_train.py's limits."""
  jmodel, jparams = _build(use_fused_warp=False)
  model = port_model()
  model.use_fused_warp = False
  assert model.fused_route
  batch = _batch()
  batch['background_points'] = np.random.RandomState(6).normal(
      size=(32, 3)).astype(np.float32)
  scalars = dict(learning_rate=1e-3, elastic_loss_weight=0.01,
                 background_loss_weight=1.0)
  switches = dict(use_elastic_loss=True, elastic_reduce_method='weight',
                  use_background_loss=True)
  key = random.PRNGKey(7)
  jstate = jax_training.create_train_state(jparams, warp_alpha=_WARP_ALPHA)
  jnew, jstats, _ = jax_training.train_step(
      jmodel, key, jstate, batch, jax_training.ScalarParams(**scalars),
      **switches)
  draws = _jax_background_draws(jmodel, random.split(key, 4)[3], 32)
  step = training.make_train_step(
      model, configs.TrainConfig(batch_size=12, **switches), device='cpu')
  state = training.create_train_state(
      interop.params_from_jax(jparams, device='cpu'), warp_alpha=_WARP_ALPHA)
  with mock.patch.object(fused_warp, 'warp_mlp_train',
                         side_effect=AssertionError('warp kernel called')):
    new_state, stats = step(None, state, batch,
                            training.ScalarParams(**scalars), draws)
  want = {'/'.join(k.key for k in path): float(v) for path, v in
          jax.tree_util.tree_flatten_with_path(jstats)[0]}
  got = {'/'.join(path): float(v)
         for path, v in fused_mlp.flatten_tree(stats)}
  assert set(got) == set(want)
  for name, value in want.items():
    np.testing.assert_allclose(got[name], value, rtol=0.05, atol=5e-4,
                               err_msg=name)
  grad_check(new_state.opt_state.mu, jnew.opt_state.mu, 'gradient')


