"""One training step in both packages, every draw of the step handed
across, for the step parity tests.

The stratified jitter and the inverse-CDF u's are drawn with numpy and
replayed into JAX's rendering module and the port's `mesh.draw`; the
background loss's warp ids and noise go into both steps. Each gradient is
recovered from the first Adam moment, (mu' - b1 mu) / (1 - b1).
"""

import dataclasses
import functools
from typing import Any, Callable, Dict
from unittest import mock

import jax
from jax import random
from jax import tree_util
import jax.numpy as jnp
import numpy as np
import optax
import torch

from nerfies_tpu import training as jax_training
from nerfies_tpu.ops import rendering as jax_rendering
from nerfies_tpu_torch import configs
from nerfies_tpu_torch import interop
from nerfies_tpu_torch import training
from nerfies_tpu_torch.models import nerf
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.parallel import mesh
from tests.torch_parity import grad_check
from tests.torch_parity import jax_config
from tests.torch_parity import jax_model_and_shapes

# The quality bench's losses (configs.bench_train_config).
SWITCHES = dict(use_elastic_loss=True, elastic_reduce_method='weight',
                elastic_loss_type='log_svals', use_background_loss=True)
ADAM_B1 = 0.9


class Replay:
  """jax.random for a module under test, whose named draws replay given
  arrays in call order (each checked for its shape)."""

  def __init__(self, **queues):
    self.queues = {name: list(values) for name, values in queues.items()}

  def __getattr__(self, name):
    if name not in self.queues:
      return getattr(random, name)

    def replay(key, *args, shape=None, **kwargs):
      del key, kwargs
      value = self.queues[name].pop(0)
      want = shape if shape is not None else args[0]
      assert tuple(want) == value.shape, (name, want, value.shape)
      return jnp.asarray(value)

    return replay


@dataclasses.dataclass
class StepPair:
  """Both packages' step: stats by '/'-joined name, gradients and updates
  as trees (JAX's of numpy arrays, the port's of float64 tensors)."""
  jax_stats: Dict[str, float]
  jax_grad: Any
  jax_update: Any
  stats: Dict[str, float]
  grad: Any
  update: Any
  fused_route: bool


def step_pair(config: configs.ModelConfig, ids: Dict[str, Any], params,
              batch, scalars: Dict[str, float], warp_alpha: float,
              seed: int = 11) -> Callable[..., StepPair]:
  """JAX's jitted `train_step` and the port's `make_train_step`, built
  once for `params` and `batch` (numpy rays, rgb and background points)
  with the quality bench's losses; the draws of the step are made here.

  Args:
    config: the port's model config (JAX's has the same fields).
    ids: construct_nerf's appearance, camera and warp ids, near and far.
    params: a nested mapping of numpy arrays.
    scalars: ScalarParams' fields.
    seed: numpy's seed for the draws handed across.

  Returns:
    step(count=0, mu=None, nu=None) -> StepPair: one step of each package
    from `params` with that Adam state (count: the Adam count and step
    before the step; mu, nu: trees of numpy arrays, zero where None).
  """
  kwargs = dict(ids, use_warp_jacobian=True, use_weights=True)
  jmodel, _ = jax_model_and_shapes(
      jax_config(**dataclasses.asdict(config)), **kwargs)
  model, _ = nerf.construct_nerf(config, device='cpu', **kwargs)
  rays = batch['origins'].shape[0]
  rng = np.random.RandomState(seed)
  coarse_u = rng.uniform(size=(rays, config.num_coarse_samples)).astype(
      np.float32)
  fine_u = rng.uniform(size=(rays, config.num_fine_samples)).astype(
      np.float32)
  points = batch['background_points'].shape[0]
  choice = rng.randint(0, len(ids['warp_ids']), (points, 1))
  bg_ids = np.asarray(ids['warp_ids'])[choice]
  bg_noise = rng.normal(size=(points, 3)).astype(np.float32)
  jparams = jax.tree.map(jnp.asarray, params)
  # The draws enter JAX's program when it is traced, on the first call.
  jax_step = jax.jit(functools.partial(jax_training.train_step, jmodel,
                                       **SWITCHES))
  port_step = training.make_train_step(
      model, configs.TrainConfig(batch_size=rays, **SWITCHES), device='cpu')

  def step(count: int = 0, mu=None, nu=None) -> StepPair:
    mu = jax.tree.map(np.zeros_like, params) if mu is None else mu
    nu = jax.tree.map(np.zeros_like, params) if nu is None else nu
    jstate = jax_training.create_train_state(
        jparams, warp_alpha=warp_alpha).replace(
            step=jnp.asarray(count, jnp.int32),
            opt_state=optax.ScaleByAdamState(
                count=jnp.asarray(count, jnp.int32),
                mu=jax.tree.map(jnp.asarray, mu),
                nu=jax.tree.map(jnp.asarray, nu)))
    with mock.patch.object(jax_rendering, 'random',
                           Replay(uniform=[coarse_u, fine_u])), \
        mock.patch.object(jax_training, 'random', Replay(
            choice=[bg_ids.astype(np.uint32)], normal=[bg_noise])):
      jnew, jstats, _ = jax_step(random.PRNGKey(0), jstate,
                                 jax.tree.map(jnp.asarray, batch),
                                 jax_training.ScalarParams(**scalars))

    state = interop.train_state_from_jax(
        params, {'count': count, 'mu': mu, 'nu': nu}, step=count,
        warp_alpha=warp_alpha, device='cpu')
    queue = [torch.from_numpy(coarse_u), torch.from_numpy(fine_u)]

    def replay(fn, shape, generator, **kwargs):
      del generator, kwargs
      assert fn is torch.rand and tuple(shape) == tuple(queue[0].shape)
      return queue.pop(0)

    with mock.patch.object(mesh, 'draw', replay):
      new_state, stats = port_step(
          torch.Generator(), state, batch, training.ScalarParams(**scalars),
          (torch.from_numpy(bg_ids.astype(np.int64)),
           torch.from_numpy(bg_noise)))
    assert not queue and new_state.opt_state.count == count + 1

    def jax_recover(new, old):
      return (np.asarray(new, np.float64)
              - ADAM_B1 * np.asarray(old, np.float64)) / (1 - ADAM_B1)

    return StepPair(
        jax_stats={'/'.join(k.key for k in path): float(v) for path, v in
                   tree_util.tree_flatten_with_path(jstats)[0]},
        jax_grad=jax.tree.map(jax_recover, jnew.opt_state.mu,
                              jstate.opt_state.mu),
        jax_update=jax.tree.map(
            lambda a, b: (np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)),
            jnew.params, jparams),
        stats={'/'.join(path): float(v)
               for path, v in fused_mlp.flatten_tree(stats)},
        grad=training._map(
            lambda new, old: (new.double() - ADAM_B1 * old.double())
            / (1 - ADAM_B1), new_state.opt_state.mu, state.opt_state.mu),
        update=training._map(
            lambda a, b: a.detach().double() - b.detach().double(),
            new_state.params, state.params),
        fused_route=model.fused_route)

  return step


def check_step(pair: StepPair, route: str, update: bool = True) -> None:
  """The stats, the gradient and (with `update`) the Adam update of
  `pair` at a route's limits: the plain float32 route at test_plain_route_step_matches_jax's
  (stats rtol 1e-4, atol 1e-6; per leaf cosine >= 0.9999 and norm ratio
  1 +- 1e-3), the fused bf16 route at tests/test_fused_train.py's (rtol
  0.05, atol 5e-4; cosine > 0.95, norm ratio in (0.7, 1.4))."""
  assert set(pair.stats) == set(pair.jax_stats)
  rtol, atol = (1e-4, 1e-6) if route == 'plain' else (0.05, 5e-4)
  limits = (dict(cos_floor=0.9999, ratio=(1 - 1e-3, 1 + 1e-3))
            if route == 'plain' else {})
  for name, value in pair.jax_stats.items():
    np.testing.assert_allclose(pair.stats[name], value, rtol=rtol,
                               atol=atol, err_msg=name)
  grad_check(pair.grad, pair.jax_grad, 'gradient', **limits)
  if update:
    grad_check(pair.update, pair.jax_update, 'update', **limits)
