"""Training: the loss stack and the optimizer step.

Port of nerfies_tpu/training.py:35-330, for one device. The forward takes
JAX's route (nerfies_tpu/training.py:277): fused_train.model_forward (the
fused kernels) when `use_fused_mlp` and fused_train.supported hold, else
NerfModel.forward (the plain `model.apply`); the losses are
plain differentiable PyTorch; the gradient is one autograd pass; Adam is
written out on tensors, equal to `optax.scale_by_adam(0.9, 0.999, 1e-8)`
followed by a step of -learning_rate, as in the JAX step. Updates are
functional: a step returns new param tensors and leaves the old ones as
they were, as the JAX step does.

Random draws (sampling jitter, density noise, the background loss's warp
ids and noise) come from one torch.Generator on the batch's device, in
the order coarse level, fine level, background; the JAX step splits its
key instead, so the two draw different numbers.

The 'median' elastic reduction without dense Jacobians linearizes the
plain warp field at each ray's median-depth point (`_median_jacobian`),
as JAX does.

Data parallelism (nerfies_tpu/training.py:327-360, `compile_train_step`
on a mesh): under a process group of N ranks (parallel/mesh.py) each
rank steps on its contiguous 1/N of the global batch, draws its rows of
the global draws (`mesh.shard_generator`), and the gradients and stats
are averaged over ranks in one all-reduce before Adam; `metric/psnr` is
then derived from the averaged `loss/rgb`, as JAX derives it from the
global batch's. At world size 1 nothing is reduced.
Under torch.profiler the step's phases are named ranges (utils.span):
`train.step` around the whole step, `train.to_device`, `train.forward`,
`train.loss`, `train.backward` (autograd's pass and the zero fill of
unused gradients), `train.all_reduce` and `train.optimizer`.
The training CLI (train.py) drives `make_train_step` with the schedules
(schedules.py), the data pipeline (datasets/) and checkpoints
(checkpoints.py).
"""

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from nerfies_tpu_torch import fused_train
from nerfies_tpu_torch import resolve_device
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops import mathutils
from nerfies_tpu_torch.ops import rendering
from nerfies_tpu_torch.ops import svd3
from nerfies_tpu_torch.parallel import mesh


@dataclasses.dataclass
class ScalarParams:
  """Per-step scalar hyperparameters (nerfies_tpu.training.ScalarParams)."""
  learning_rate: float
  elastic_loss_weight: float = 0.0
  warp_reg_loss_weight: float = 0.0
  warp_reg_loss_alpha: float = -2.0
  warp_reg_loss_scale: float = 0.001
  background_loss_weight: float = 0.0
  background_noise_std: float = 0.001


@dataclasses.dataclass
class AdamState:
  """optax.ScaleByAdamState: the step count and the two moment trees."""
  count: int
  mu: Dict[str, Any]
  nu: Dict[str, Any]


@dataclasses.dataclass
class TrainState:
  """Params (leaves with requires_grad), Adam state and warp alphas."""
  step: int
  params: Dict[str, Any]
  opt_state: AdamState
  warp_alpha: float = 0.0
  time_alpha: float = 0.0

  @property
  def warp_extra(self) -> Dict[str, float]:
    return {'alpha': self.warp_alpha, 'time_alpha': self.time_alpha}


def _map(fn, *trees):
  """fn over the leaves of nested dicts of one structure."""
  first = trees[0]
  if isinstance(first, dict):
    return {k: _map(fn, *[t[k] for t in trees]) for k in first}
  return fn(*trees)


def _trainable(t: torch.Tensor) -> torch.Tensor:
  return t.detach().clone().requires_grad_(True)


def create_train_state(params: Dict[str, Any], warp_alpha: float = 0.0,
                       time_alpha: float = 0.0) -> TrainState:
  """Fresh Adam moments (zeros, count 0) around copies of `params`."""
  zeros = lambda: _map(lambda p: torch.zeros_like(p, requires_grad=False),
                       params)
  return TrainState(step=0, params=_map(_trainable, params),
                    opt_state=AdamState(0, zeros(), zeros()),
                    warp_alpha=float(warp_alpha),
                    time_alpha=float(time_alpha))


@utils.spanned('train.optimizer')
def adam_update(grads, opt_state: AdamState, params, learning_rate,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
  """optax.scale_by_adam then -learning_rate (training.py:312-320).

  mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu; with count + 1 = k,
  update = mu / (1 - b1^k) / (sqrt(nu / (1 - b2^k)) + eps), and
  p <- p + (-learning_rate * update). Returns (new params, new state).
  """
  count = opt_state.count + 1
  # The bias corrections in float32, as optax computes them.
  bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
  bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
  mu = _map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, opt_state.mu)
  nu = _map(lambda g, v: (1.0 - b2) * (g * g) + b2 * v, grads, opt_state.nu)

  def step(p, m, v):
    update = (m / bc1.to(m.device)) / (
        torch.sqrt(v / bc2.to(v.device)) + eps)
    return _trainable(p + (-learning_rate) * update)

  return _map(step, params, mu, nu), AdamState(count, mu, nu)


def compute_elastic_loss(jacobian: torch.Tensor, eps: float = 1e-6,
                         loss_type: str = 'log_svals', alpha: float = -2.0,
                         scale: float = 0.03):
  """Elastic regularizer on (3, 3, ...) warp Jacobians (training.py:86).

  Returns:
    (loss, residual), each shaped like the Jacobian batch (...,).
  """
  if loss_type == 'log_svals':
    svals = svd3.svals3(jacobian, eps=eps ** 2)
    sq_residual = torch.sum(torch.log(torch.clamp(svals, min=eps)) ** 2,
                            dim=0)
  elif loss_type == 'svals':
    svals = svd3.svals3(jacobian, eps=eps ** 2)
    sq_residual = torch.sum((svals - 1.0) ** 2, dim=0)
  elif loss_type == 'jtj':
    def row_dot(i, k):
      return (jacobian[i, 0] * jacobian[k, 0] + jacobian[i, 1] * jacobian[k, 1]
              + jacobian[i, 2] * jacobian[k, 2])
    sq_residual = ((row_dot(0, 0) - 1.0) ** 2 + (row_dot(1, 1) - 1.0) ** 2
                   + (row_dot(2, 2) - 1.0) ** 2
                   + 2.0 * (row_dot(0, 1) ** 2 + row_dot(0, 2) ** 2
                            + row_dot(1, 2) ** 2)) / 4.0
  elif loss_type == 'div':
    sq_residual = mathutils.jacobian_to_div(jacobian) ** 2
  elif loss_type == 'det':
    sq_residual = (svd3.det3(jacobian) - 1.0) ** 2
  elif loss_type == 'log_det':
    det = svd3.det3(jacobian)
    sq_residual = torch.log(torch.clamp(det, min=eps)) ** 2
  elif loss_type == 'nr':
    rot = svd3.nearest_rotation(jacobian)
    sq_residual = torch.sum((jacobian - rot) ** 2, dim=(0, 1))
  else:
    raise NotImplementedError(f'Unknown elastic loss type {loss_type!r}')
  residual = torch.sqrt(sq_residual)
  loss = mathutils.general_loss_with_squared_residual(
      sq_residual, alpha=alpha, scale=scale)
  return loss, residual


def draw_background(model, num_points: int,
                    generator: Optional[torch.Generator],
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
  """The background loss's draws: (P, 1) warp ids from model.warp_ids,
  uniformly, and (P, 3) standard normal noise."""
  ids = torch.as_tensor(model.warp_ids, dtype=torch.int64, device=device)
  choice = mesh.draw(functools.partial(torch.randint, len(model.warp_ids)),
                     (num_points, 1), generator, device=device)
  noise = mesh.draw(torch.randn, (num_points, 3), generator, device=device)
  return ids[choice], noise


def compute_background_loss(model, state: TrainState, params, points,
                            noise_std, generator=None, draws=None,
                            alpha: float = -2.0, scale: float = 0.001):
  """Penalizes warping of known-static background points (training.py:137).

  Re-applies the warp field, with the params the ray march uses, to the
  points plus noise_std times normal noise, each under a random warp id,
  through NerfModel.apply_warp: on the fused route with use_fused_warp the
  fused kernel with no tangents, the same function as the JAX package's
  flax `apply_warp` (tests/test_fused_train.py pins the two together);
  otherwise the plain field, as in JAX.

  Args:
    points: (P, 3) background points.
    generator: draws the ids and the noise, unless `draws` = (ids (P, 1),
      noise (P, 3)) gives them.

  Returns:
    (P,) Barron losses of the squared displacement.
  """
  if draws is None:
    draws = draw_background(model, points.shape[0], generator, points.device)
  ids, noise = draws
  points = points + noise_std * noise
  warped = model.apply_warp(params, points[:, None, :], ids,
                            state.warp_extra)['warped_points'][:, 0]
  sq_residual = torch.sum((warped - points) ** 2, dim=-1)
  return mathutils.general_loss_with_squared_residual(
      sq_residual, alpha=alpha, scale=scale)


def _take_depth(values, weights):
  """values[..., i] at each ray's median-depth sample i, keeping the axis.

  values: (B, S) or (3, 3, B, S); weights: (B, S), its gradient stopped.
  """
  index = rendering.compute_depth_index(weights.detach())
  index = index.reshape((1,) * (values.dim() - 2) + (-1, 1))
  return torch.gather(values, -1, index.expand(*values.shape[:-1], 1))


def train_step(model,
               generator: Optional[torch.Generator],
               state: TrainState,
               batch: Dict[str, Any],
               scalar_params: ScalarParams,
               use_elastic_loss: bool = False,
               elastic_reduce_method: str = 'median',
               elastic_loss_type: str = 'log_svals',
               use_background_loss: bool = False,
               use_warp_reg_loss: bool = False,
               background_draws: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None):
  """One optimization step over the ray batch (training.py:160).

  Args:
    model: the NerfModel (static architecture).
    generator: the step's random stream, on the batch's device (None for
      a model without stratified sampling and with `background_draws`);
      the same on every rank of a data-parallel run.
    state: TrainState; its params lie on the batch's device.
    batch: {'origins', 'directions', 'rgb', 'metadata', 'background_points'?}
      as tensors: this rank's slice of the global batch.
    scalar_params: the step's scalars (learning rate, loss weights).
    use_*: the loss switches, as in the JAX step.
    background_draws: (ids, noise) for the background loss in place of
      drawing them (see compute_background_loss), for this rank's points.

  Returns:
    (new_state, stats): stats holds 0-d tensors per level
    ('fine' / 'coarse' dicts) and 'background_loss', as the JAX step's;
    under a process group, the means over ranks.
  """
  params = state.params
  generator = mesh.shard_generator(generator)

  def median_jacobian(model_out):
    """The (3, 3, B, 1) warp Jacobians at each ray's median-depth point
    (training.py:186-212): the pre-warp points gathered by the detached
    coarse weights, linearized through the plain field."""
    index = rendering.compute_depth_index(model_out['weights'].detach())
    points = torch.gather(model_out['points'], 1,
                          index[:, None, None].expand(-1, 1, 3))
    metadata = batch['metadata']
    warp_metadata = (metadata['time']
                     if model.warp_metadata_encoder_type == 'time'
                     else metadata['warp'])
    return model.warp_field(params, points, warp_metadata, state.warp_extra,
                            return_jacobian=True)['jacobian']

  def level_loss(model_out, level_uses_elastic):
    rgb_loss = ((model_out['rgb'] - batch['rgb'][..., :3]) ** 2).mean()
    stats = {'loss/rgb': rgb_loss}
    loss = rgb_loss
    stats_jacobian = model_out.get('warp_jacobian')
    if level_uses_elastic:
      if elastic_reduce_method == 'median':
        if 'warp_jacobian' in model_out:
          jacobian = _take_depth(model_out['warp_jacobian'],
                                 model_out['weights'])
        else:
          # The stats then cover the gathered samples, as in JAX.
          jacobian = stats_jacobian = median_jacobian(model_out)
      else:
        jacobian = model_out['warp_jacobian']
      elastic_loss, elastic_residual = compute_elastic_loss(
          jacobian, loss_type=elastic_loss_type)
      if elastic_reduce_method == 'weight':
        elastic_loss = model_out['weights'].detach() * elastic_loss
      elastic_loss = elastic_loss.sum(dim=-1).mean()
      stats['loss/elastic'] = elastic_loss
      stats['residual/elastic'] = elastic_residual.mean()
      loss = loss + scalar_params.elastic_loss_weight * elastic_loss
    if use_warp_reg_loss:
      warp_mag = ((model_out['points']
                   - model_out['warped_points']) ** 2).sum(dim=-1)
      warp_reg_residual = _take_depth(warp_mag, model_out['weights'])
      warp_reg_loss = mathutils.general_loss_with_squared_residual(
          warp_reg_residual, alpha=scalar_params.warp_reg_loss_alpha,
          scale=scalar_params.warp_reg_loss_scale).mean()
      stats['loss/warp_reg'] = warp_reg_loss
      stats['residual/warp_reg'] = mathutils.safe_sqrt(
          warp_reg_residual).mean()
      loss = loss + scalar_params.warp_reg_loss_weight * warp_reg_loss
    if stats_jacobian is not None:
      stats_jacobian = stats_jacobian.detach()
      stats['metric/jacobian_det'] = svd3.det3(stats_jacobian).mean()
      stats['metric/jacobian_div'] = mathutils.jacobian_to_div(
          stats_jacobian).mean()
      stats['metric/jacobian_curl'] = torch.linalg.norm(
          mathutils.jacobian_to_curl(stats_jacobian), dim=0).mean()
    stats['loss/total'] = loss
    stats['metric/psnr'] = mathutils.compute_psnr(rgb_loss)
    return loss, stats

  need_points = use_warp_reg_loss or (
      use_elastic_loss and elastic_reduce_method == 'median')
  coarse_gen = fine_gen = (generator if model.use_stratified_sampling
                           else None)
  return_weights = use_warp_reg_loss or use_elastic_loss
  with utils.span('train.forward'):
    if model.fused_route:
      ret = fused_train.model_forward(
          model, params, batch, state.warp_extra, coarse_gen, fine_gen,
          return_points=need_points, return_weights=return_weights)
    else:
      ret = model(params, batch, state.warp_extra, return_points=need_points,
                  return_weights=return_weights, coarse_generator=coarse_gen,
                  fine_generator=fine_gen)
  with utils.span('train.loss'):
    losses, stats = {}, {}
    if 'fine' in ret:
      losses['fine'], stats['fine'] = level_loss(ret['fine'], False)
    if 'coarse' in ret:
      losses['coarse'], stats['coarse'] = level_loss(ret['coarse'],
                                                     use_elastic_loss)
    if use_background_loss:
      background_loss = compute_background_loss(
          model, state, params, batch['background_points'],
          scalar_params.background_noise_std, generator=generator,
          draws=background_draws).mean()
      losses['background'] = (scalar_params.background_loss_weight
                              * background_loss)
      stats['background_loss'] = background_loss
    total = sum(losses.values())

  flat = fused_mlp.flatten_tree(params)
  leaves = [t for _, t in flat]
  with utils.span('train.backward'):
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
  stats = _map(lambda t: t.detach(), stats)
  if mesh.world_size() > 1:
    grads, stats = _mean_over_ranks(grads, stats)
  grads = fused_mlp.unflatten_tree([p for p, _ in flat], grads)
  with torch.no_grad():
    new_params, new_opt_state = adam_update(
        grads, state.opt_state, params, scalar_params.learning_rate)
  return dataclasses.replace(state, step=state.step + 1, params=new_params,
                             opt_state=new_opt_state), stats


@utils.spanned('train.all_reduce')
def _mean_over_ranks(grads, stats):
  """The gradients and stats averaged over ranks in one all-reduce, with
  each level's `metric/psnr` derived anew from its averaged `loss/rgb`."""
  flat_stats = fused_mlp.flatten_tree(stats)
  values = [t.to(grads[0].dtype).reshape(1) for _, t in flat_stats]
  reduced = mesh.all_reduce_mean(list(grads) + values)
  grads = reduced[:len(grads)]
  stats = fused_mlp.unflatten_tree(
      [p for p, _ in flat_stats],
      [t.reshape(()) for t in reduced[len(grads):]])
  for level in stats.values():
    if isinstance(level, dict) and 'metric/psnr' in level:
      level['metric/psnr'] = mathutils.compute_psnr(level['loss/rgb'])
  return grads, stats


def step_generator(seed: int, step: int, device) -> torch.Generator:
  """The random stream of one step: a generator on `device` seeded from
  (seed, step), the counterpart of `random.fold_in(rng, step)`.

  A run resumed at a step draws there what an unbroken run draws.
  """
  return utils.fold_in(seed, step, device)


def make_train_step(model, train_config, device='cuda'):
  """The step of `train_step` with the config's loss switches bound.

  The counterpart of nerfies_tpu.training.compile_train_step for one
  device: returns step(generator, state, batch, scalar_params,
  background_draws=None) -> (new_state, stats), which moves the batch
  (numpy arrays or tensors) to `device` first. The state's params must
  already lie there. Runs on the card unless told device='cpu'.

  The step takes the model's route (NerfModel.fused_route).

  Raises:
    NotImplementedError: for an activation other than relu on the fused
      route (fused_train.check_trainable).
  """
  device = resolve_device(device)
  fused_train.check_trainable(model)

  @utils.spanned('train.step')
  def step(generator, state, batch, scalar_params, background_draws=None):
    with utils.span('train.to_device'):
      batch = utils.to_device(batch, device)
    return train_step(
        model, generator, state, batch, scalar_params,
        use_elastic_loss=train_config.use_elastic_loss,
        elastic_reduce_method=train_config.elastic_reduce_method,
        elastic_loss_type=train_config.elastic_loss_type,
        use_background_loss=train_config.use_background_loss,
        use_warp_reg_loss=train_config.use_warp_reg_loss,
        background_draws=background_draws)

  return step
