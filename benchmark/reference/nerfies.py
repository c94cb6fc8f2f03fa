"""The plain reference: Nerfies' deformable NeRF in float32 PyTorch.

Written from the published model (Park et al., "Nerfies: Deformable Neural
Radiance Fields", ICCV 2021, and google/nerfies): the SE(3) warp field,
both NeRF levels, stratified and hierarchical sampling, compositing, the
rgb, elastic ('log_svals', density-weighted) and background losses, and
Adam. It imports nothing of the program and takes nothing the program
made: it is handed the benchmark's weights, rays and random streams.

Every product is a float32 `torch.matmul` with TF32 off (`exact_matmuls`).
Inputs that are constant along a ray (the warp's GLO code, the rgb
condition) meet their rows of a split Dense layer once a ray, as the
published SplitDense broadcasts them.

`precision='fp8'` is the control, fp8 training as it is usually done, the
step below the bfloat16 that the configurations state: every product's two
operands are rounded to float8 e4m3 and the gradient of its output to
e5m2, each under a per-tensor scale (amax to the format's largest value),
and accumulated in float32.

Random draws follow the documented order of the program's step, from the
generator the benchmark hands both sides: the coarse level's jitter
(B, S_coarse) uniforms, the fine level's inverse-CDF (B, S_fine)
uniforms, then the background loss's warp ids and normal noise.
"""

import contextlib
import math
from typing import Dict, Optional

import torch

# The published choices this reference writes out; a configuration that
# departs from one is refused rather than computed otherwise.
SUPPORTED = {
    'activation': 'relu', 'sigma_activation': 'softplus',
    'use_sample_at_infinity': True, 'use_white_background': False,
    'use_linear_disparity': False, 'use_viewdirs': True, 'noise_std': None,
    'use_trunk_condition': False, 'use_alpha_condition': False,
    'use_warp': True, 'warp_field_type': 'se3',
    'warp_metadata_encoder_type': 'glo', 'warp_kwargs': {},
}


@contextlib.contextmanager
def exact_matmuls():
  """float32 products without TF32 inside the block."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision('highest')
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
  """x rounded to `dtype` under a per-tensor scale that takes its largest
  magnitude to the format's largest finite value."""
  scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
  return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
  """x @ w as fp8 training computes it: operands in e4m3, the output's
  gradient in e5m2, products accumulated in float32."""

  @staticmethod
  def forward(ctx, x, w):
    xq = _round(x, torch.float8_e4m3fn)
    wq = _round(w, torch.float8_e4m3fn)
    ctx.save_for_backward(xq, wq)
    return xq @ wq

  @staticmethod
  def backward(ctx, grad):
    xq, wq = ctx.saved_tensors
    gq = _round(grad, torch.float8_e5m2)
    dx = gq @ wq.transpose(-1, -2)
    dw = xq.reshape(-1, xq.shape[-1]).transpose(0, 1) @ gq.reshape(
        -1, gq.shape[-1])
    return dx, dw


class Reference:
  """The model of one configuration (the `model` section of its file)."""

  def __init__(self, model: Dict, near: float, far: float,
               precision: str = 'fp32'):
    if precision not in ('fp32', 'fp8'):
      raise ValueError(f'unknown precision {precision!r}')
    for key, wanted in SUPPORTED.items():
      if model.get(key) != wanted:
        raise ValueError(f'the reference computes {key} = {wanted!r}, '
                         f'not {model.get(key)!r}')
    self.m = model
    self.near, self.far = near, far
    self.precision = precision

  # -- layers ---------------------------------------------------------------

  def matmul(self, x, w):
    if self.precision == 'fp8':
      return _Fp8Matmul.apply(x, w)
    return x @ w

  def dense(self, p, inputs):
    """Split Dense: concat(inputs) @ kernel + bias, each input's rows of the
    kernel applied to it alone and the terms broadcast."""
    out, offset = None, 0
    for x in inputs:
      rows = x.shape[-1]
      term = self.matmul(x, p['kernel'][offset:offset + rows])
      out = term if out is None else out + term
      offset += rows
    return out + p['bias']

  @staticmethod
  def posenc(x, num_freqs, alpha=None):
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(F-1) x), cos(...)], each
    band C channels wide, eased by the window of `alpha`."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    angles = x[..., None, :] * freqs[:, None]  # (..., F, C)
    feats = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-2)
    if alpha is not None:
      bands = torch.arange(num_freqs, dtype=x.dtype, device=x.device)
      window = 0.5 * (1.0 - torch.cos(
          math.pi * torch.clamp(alpha - bands, 0.0, 1.0)))
      feats = feats * window[:, None, None]
    return torch.cat([x, feats.flatten(-3)], dim=-1)

  # -- warp -------------------------------------------------------------------

  def _warp_trunk(self, p, pe, code, tangents=()):
    """The SE(3) field's trunk and head on (..., S, pe) encodings and
    (..., 1, F) codes; tangents ride along through the ReLU masks."""
    h, th = None, list(tangents)
    for i in range(6):
      layer = p['trunk'][f'hidden_{i}']
      if h is None:
        z = self.dense(layer, [pe, code])
        tz = [self.matmul(t, layer['kernel'][:pe.shape[-1]]) for t in th]
      elif i == 4:
        z = self.dense(layer, [h, pe, code])
        w = layer['kernel']
        tz = [self.matmul(t_h, w[:h.shape[-1]])
              + self.matmul(t, w[h.shape[-1]:h.shape[-1] + pe.shape[-1]])
              for t_h, t in zip(th_h, th)]
      else:
        z = self.dense(layer, [h])
        tz = [self.matmul(t_h, layer['kernel']) for t_h in th_h]
      mask = (z > 0).to(z.dtype)
      h = torch.relu(z)
      th_h = [t * mask for t in tz]
    head = p['branches_wv']['logit']
    out = self.dense(head, [h])
    touts = [self.matmul(t_h, head['kernel']) for t_h in th_h] if th else []
    return out, touts

  @staticmethod
  def se3_apply(w, v, x):
    """exp([w, v]) applied to x, with |w| the angle (series below 0.1)."""
    t2 = (w * w).sum(-1, keepdim=True)
    safe = torch.clamp(t2, min=0.005)
    t = torch.sqrt(safe)
    small = t2 < 0.01
    a = torch.where(small, 1 - t2 / 6 + t2 * t2 / 120, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24 + t2 * t2 / 720,
                    (1 - torch.cos(t)) / safe)
    c = torch.where(small, 1 / 6 - t2 / 120 + t2 * t2 / 5040,
                    (t - torch.sin(t)) / (safe * t))
    wx = torch.linalg.cross(w, x, dim=-1)
    wv = torch.linalg.cross(w, v, dim=-1)
    return (x + a * wx + b * torch.linalg.cross(w, wx, dim=-1)
            + v + b * wv + c * torch.linalg.cross(w, wv, dim=-1))

  def warp(self, params, points, warp_ids, alpha, jacobian=False):
    """(..., S, 3) points under (..., 1) warp ids -> warped points and,
    with `jacobian`, d warped_i / d x_j as (3, 3, ..., S)."""
    p = params['warp_field']
    code = p['metadata_encoder']['embed']['embedding'][warp_ids[..., 0]]
    code = code[..., None, :]
    freqs = self.m['num_warp_freqs']
    pe = self.posenc(points, freqs, alpha)
    tangents = ()
    if jacobian:
      f = 2.0 ** torch.arange(freqs, dtype=points.dtype,
                              device=points.device)
      bands = torch.arange(freqs, dtype=points.dtype, device=points.device)
      window = 0.5 * (1.0 - torch.cos(
          math.pi * torch.clamp(alpha - bands, 0.0, 1.0)))
      angles = points[..., None, :] * f[:, None]
      slope = torch.stack([torch.cos(angles), -torch.sin(angles)], dim=-2)
      slope = slope * (f * window)[:, None, None]  # (..., F, 2, C)
      cols = []
      for j in range(3):
        eye = torch.zeros_like(points)
        eye[..., j] = 1.0
        d = torch.zeros_like(slope)
        d[..., j] = slope[..., j]
        cols.append(torch.cat([eye, d.flatten(-3)], dim=-1))
      tangents = tuple(cols)
    out, touts = self._warp_trunk(p, pe, code, tangents)
    w, v = out[..., :3], out[..., 3:6]
    warped = self.se3_apply(w, v, points)
    if not jacobian:
      return warped, None
    columns = []
    for j in range(3):
      eye = torch.zeros_like(points)
      eye[..., j] = 1.0
      _, col = torch.func.jvp(self.se3_apply, (w, v, points),
                              (touts[j][..., :3], touts[j][..., 3:6], eye))
      columns.append(col)
    jac = torch.stack([torch.stack([columns[j][..., i] for j in range(3)])
                       for i in range(3)])
    return warped, jac

  # -- NeRF -----------------------------------------------------------------

  def conditions(self, params, directions, metadata):
    """The per-ray rgb condition: viewdir encoding, then the GLO codes."""
    parts = [self.posenc(directions, self.m['num_nerf_viewdir_freqs'])]
    if self.m['use_appearance_metadata'] and self.m['use_rgb_condition']:
      table = params['appearance_encoder']['embed']['embedding']
      parts.append(table[metadata['appearance'][..., 0]])
    if self.m['use_camera_metadata']:
      table = params['camera_encoder']['embed']['embedding']
      parts.append(table[metadata['camera'][..., 0]])
    return torch.cat(parts, dim=-1)[..., None, :]

  def nerf_mlp(self, p, points, condition):
    pe = self.posenc(points, self.m['num_nerf_point_freqs'])
    h = None
    for i in range(self.m['nerf_trunk_depth']):
      inputs = [pe] if h is None else (
          [h, pe] if i in self.m['nerf_skips'] else [h])
      h = torch.relu(self.dense(p[f'trunk_hidden_{i}'], inputs))
    alpha = self.dense(p['alpha_logit'], [h])[..., 0]
    y = [self.dense(p['bottleneck'], [h]), condition]
    for i in range(self.m['nerf_rgb_branch_depth']):
      y = [torch.relu(self.dense(p[f'rgb_hidden_{i}'], y))]
    rgb = self.dense(p['rgb_logit'], y)
    return rgb, alpha

  def composite(self, rgb_raw, raw_sigma, z, directions):
    pad = self.m['rgb_padding']
    rgb = torch.sigmoid(rgb_raw) * (1 + 2 * pad) - pad
    sigma = torch.nn.functional.softplus(raw_sigma)
    dists = torch.cat([z[..., 1:] - z[..., :-1],
                       torch.full_like(z[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(directions, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-10],
        dim=-1), dim=-1)
    weights = alpha * trans
    return {'rgb': (weights[..., None] * rgb).sum(-2),
            'depth': (weights * z).sum(-1),
            'acc': weights[..., :-1].sum(-1),
            'weights': weights}

  def level(self, params, name, points, z, directions, metadata, condition,
            alpha, jacobian=False):
    jac = None
    if self.m['use_warp']:
      points, jac = self.warp(params, points, metadata['warp'], alpha,
                              jacobian)
    rgb, sigma = self.nerf_mlp(params[f'nerf_mlps_{name}'], points,
                               condition)
    out = self.composite(rgb, sigma, z, directions)
    out['jacobian'] = jac
    return out

  # -- sampling -------------------------------------------------------------

  def coarse_samples(self, origins, directions, u: Optional[torch.Tensor]):
    s = self.m['num_coarse_samples']
    t = torch.linspace(0.0, 1.0, s, device=origins.device)
    z = self.near * (1.0 - t) + self.far * t
    if u is not None:
      mids = 0.5 * (z[1:] + z[:-1])
      upper = torch.cat([mids, z[-1:]])
      lower = torch.cat([z[:1], mids])
      z = lower + (upper - lower) * u
    else:
      z = z.expand(origins.shape[0], s)
    return z, origins[:, None] + z[..., None] * directions[:, None]

  def fine_samples(self, origins, directions, z, weights, u):
    """The sorted union of the coarse depths and inverse-CDF samples of
    the coarse weights (eps 1e-5 a bin), u given or a uniform grid."""
    bins = 0.5 * (z[..., 1:] + z[..., :-1])
    w = weights[..., 1:-1].detach() + 1e-5
    cdf = torch.cumsum(w, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf / cdf[..., -1:]],
                    -1)
    n = self.m['num_fine_samples']
    if u is None:
      u = torch.linspace(0.0, 1.0, n, device=z.device).expand(z.shape[0], n)
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(idx - 1, 0, w.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, below + 1)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, below + 1)
    span = c1 - c0
    frac = (u - c0) / torch.where(span < 1e-5, torch.ones_like(span), span)
    samples = (b0 + frac * (b1 - b0)).detach()
    z, _ = torch.sort(torch.cat([z.detach(), samples], -1), -1)
    return z, origins[:, None] + z[..., None] * directions[:, None]

  # -- rendering and training -----------------------------------------------

  def render(self, params, origins, directions, metadata, alpha):
    """Deterministic coarse and fine levels of a flat ray batch: the fine
    level's rgb, depth and acc."""
    condition = self.conditions(params, directions, metadata)
    z, pts = self.coarse_samples(origins, directions, None)
    coarse = self.level(params, 'coarse', pts, z, directions, metadata,
                        condition, alpha)
    z, pts = self.fine_samples(origins, directions, z, coarse['weights'],
                               None)
    fine = self.level(params, 'fine', pts, z, directions, metadata,
                      condition, alpha)
    return {k: fine[k] for k in ('rgb', 'depth', 'acc')}

  def ray_losses(self, params, batch, u_coarse, u_fine, alpha,
                 elastic_weight):
    """Summed (not averaged) rgb and weighted elastic losses of a block of
    rays, and their parts, for a caller that divides by the batch."""
    origins, directions = batch['origins'], batch['directions']
    metadata = batch['metadata']
    condition = self.conditions(params, directions, metadata)
    z, pts = self.coarse_samples(origins, directions, u_coarse)
    coarse = self.level(params, 'coarse', pts, z, directions, metadata,
                        condition, alpha, jacobian=True)
    z, pts = self.fine_samples(origins, directions, z, coarse['weights'],
                               u_fine)
    fine = self.level(params, 'fine', pts, z, directions, metadata,
                      condition, alpha)
    target = batch['rgb'][..., :3]
    rgb_c = ((coarse['rgb'] - target) ** 2).sum() / 3.0
    rgb_f = ((fine['rgb'] - target) ** 2).sum() / 3.0
    svals = torch.linalg.svdvals(coarse['jacobian'].permute(2, 3, 0, 1))
    sq = (torch.log(torch.clamp(svals, min=1e-6)) ** 2).sum(-1)
    elastic = (coarse['weights'].detach() * barron(sq, 0.03)).sum()
    total = rgb_c + rgb_f + elastic_weight * elastic
    return total, {'rgb_coarse': rgb_c, 'rgb_fine': rgb_f,
                   'elastic': elastic}

  def background_loss(self, params, points, ids, noise, alpha, noise_std):
    points = points + noise_std * noise
    warped, _ = self.warp(params, points[:, None], ids, alpha)
    sq = ((warped[:, 0] - points) ** 2).sum(-1)
    return barron(sq, 0.001).mean()


def barron(sq, scale):
  """Barron's robust loss at alpha = -2 on squared residuals, times scale:
  scale * 2 z / (z + 4), z = sq / scale^2."""
  z = sq / (scale * scale)
  return scale * 2.0 * z / (z + 4.0)


def draws(generator, batch: int, coarse: int, fine: int, points: int,
          num_warp_ids: int, device):
  """The step's random streams, in the program's documented order."""
  u_coarse = torch.rand((batch, coarse), generator=generator,
                        dtype=torch.float32, device=device)
  u_fine = torch.rand((batch, fine), generator=generator,
                      dtype=torch.float32, device=device)
  ids = torch.randint(num_warp_ids, (points, 1), generator=generator,
                      device=device)
  noise = torch.randn((points, 3), generator=generator, dtype=torch.float32,
                      device=device)
  return u_coarse, u_fine, ids, noise


def _leaves(tree, prefix=''):
  for key, value in tree.items():
    name = f'{prefix}/{key}' if prefix else key
    if isinstance(value, dict):
      yield from _leaves(value, name)
    else:
      yield name, value


def _rebuild(flat: Dict[str, torch.Tensor]):
  tree = {}
  for name, value in flat.items():
    node = tree
    parts = name.split('/')
    for key in parts[:-1]:
      node = node.setdefault(key, {})
    node[parts[-1]] = value
  return tree


def train_steps(ref: Reference, params, batches, generators, scalars: Dict,
                block: int):
  """Steps the reference through `batches` from `params` with Adam.

  Args:
    params: the initial nested param tree (not modified).
    batches: per step {'origins', 'directions', 'rgb', 'metadata',
      'background_points'} float32 / int64 tensors on one device.
    generators: per step, the generator the program was handed.
    scalars: learning_rate, elastic_loss_weight, background_loss_weight,
      background_noise_std, warp_alpha.
    block: rays a forward and backward pass at a time.

  Returns:
    (losses per step, first gradients {leaf: tensor}, params after the
    steps {leaf: tensor}).
  """
  flat = {k: v.detach().float().clone() for k, v in _leaves(params)}
  mu = {k: torch.zeros_like(v) for k, v in flat.items()}
  nu = {k: torch.zeros_like(v) for k, v in flat.items()}
  losses, first_grads = [], None
  for step, (batch, generator) in enumerate(zip(batches, generators), 1):
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    tree = _rebuild(leaves)
    n = batch['origins'].shape[0]
    u_c, u_f, ids, noise = draws(
        generator, n, ref.m['num_coarse_samples'], ref.m['num_fine_samples'],
        batch['background_points'].shape[0], scalars['num_warp_ids'],
        batch['origins'].device)
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    total = 0.0
    for lo in range(0, n, block):
      part = _slice(batch, lo, lo + block)
      loss, _ = ref.ray_losses(tree, part, u_c[lo:lo + block],
                               u_f[lo:lo + block], scalars['warp_alpha'],
                               scalars['elastic_loss_weight'])
      loss = loss / n
      _accumulate(grads, leaves, loss)
      total += float(loss.detach())
    bg = scalars['background_loss_weight'] * ref.background_loss(
        tree, batch['background_points'], ids, noise, scalars['warp_alpha'],
        scalars['background_noise_std'])
    _accumulate(grads, leaves, bg)
    total += float(bg.detach())
    losses.append(total)
    if first_grads is None:
      first_grads = {k: g.clone() for k, g in grads.items()}
    bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
    for k in flat:
      mu[k] = 0.1 * grads[k] + 0.9 * mu[k]
      nu[k] = 0.001 * grads[k] * grads[k] + 0.999 * nu[k]
      flat[k] = flat[k] - scalars['learning_rate'] * (
          (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + 1e-8))
  return losses, first_grads, flat


def _accumulate(grads, leaves, loss):
  names = list(leaves)
  got = torch.autograd.grad(loss, [leaves[k] for k in names],
                            allow_unused=True)
  for k, g in zip(names, got):
    if g is not None:
      grads[k] += g


def _slice(batch, lo, hi):
  return {k: (_slice(v, lo, hi) if isinstance(v, dict) else v[lo:hi])
          for k, v in batch.items() if k != 'background_points'}
