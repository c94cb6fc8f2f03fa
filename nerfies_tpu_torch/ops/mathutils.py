"""Differentiable numerics: safe norms, robust losses, Jacobian operators.

Port of nerfies_tpu/ops/mathutils.py. Jacobians keep the LEADING (3, 3,
...) layout of the JAX package (J[i, j] = d out_i / d in_j), which the
loss code indexes.
"""

import math

import torch


class _SafeNorm(torch.autograd.Function):
  """L2 norm whose gradient is zero (not NaN) within `tol` of the origin."""

  @staticmethod
  def forward(ctx, x, dim, keepdim, tol):
    y = torch.linalg.norm(x, dim=dim, keepdim=keepdim)
    ctx.save_for_backward(x)
    ctx.args = (dim, keepdim, tol)
    return y

  @staticmethod
  def backward(ctx, g):
    x, = ctx.saved_tensors
    dim, keepdim, tol = ctx.args
    y = torch.linalg.norm(x, dim=dim, keepdim=True)
    scale = torch.where(y > max(tol, 1e-30), 1.0 / torch.clamp(y, min=tol),
                        torch.zeros_like(y))
    if not keepdim:
      g = g.unsqueeze(dim)
    return g * x * scale, None, None, None


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              tol: float = 1e-9) -> torch.Tensor:
  """The JAX custom-JVP safe_norm (mathutils.py:14-37) as a Function."""
  return _SafeNorm.apply(x, dim, keepdim, tol)


def jacobian_to_curl(jacobian: torch.Tensor) -> torch.Tensor:
  """Curl of the displacement field, (3, ...), from (3, 3, ...) Jacobians."""
  return torch.stack([jacobian[2, 1] - jacobian[1, 2],
                      jacobian[0, 2] - jacobian[2, 0],
                      jacobian[1, 0] - jacobian[0, 1]])


def jacobian_to_div(jacobian: torch.Tensor) -> torch.Tensor:
  """trace(J) - 3 for (3, 3, ...) Jacobians of x -> x + f(x)."""
  return jacobian[0, 0] + jacobian[1, 1] + jacobian[2, 2] - 3.0


def compute_psnr(mse: torch.Tensor) -> torch.Tensor:
  """PSNR for a peak value of 1.0."""
  return -10.0 * torch.log(mse) / math.log(10.0)


def log1p_safe(x):
  return torch.log1p(torch.clamp(x, max=3e37))


def expm1_safe(x):
  return torch.expm1(torch.clamp(x, max=87.5))


def safe_sqrt(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
  return torch.sqrt(torch.where(x == 0, torch.full_like(x, eps), x))


def general_loss_with_squared_residual(squared_x: torch.Tensor, alpha,
                                       scale) -> torch.Tensor:
  """Barron's general robust loss on squared residuals (mathutils.py:124).

  scale * rho(x, alpha, c), with the removable singularities at alpha in
  {2, 0, -inf, +inf} filled by their limits, every branch evaluated and
  the right one selected, as in the JAX version.
  """
  dtype = torch.promote_types(squared_x.dtype, torch.float32)
  squared_x = squared_x.to(dtype)
  alpha = torch.as_tensor(alpha, dtype=dtype, device=squared_x.device)
  z = squared_x / (scale * scale)
  tiny = torch.finfo(dtype).eps
  abs_am2 = torch.clamp(torch.abs(alpha - 2.0), min=tiny)
  signed_a = torch.where(alpha < 0.0, -1.0, 1.0) * torch.clamp(
      torch.abs(alpha), min=tiny)
  rho = abs_am2 / signed_a * (torch.pow(z / abs_am2 + 1.0, 0.5 * alpha)
                              - 1.0)
  rho = torch.where(alpha == math.inf, expm1_safe(0.5 * z), rho)
  rho = torch.where(alpha == -math.inf, -torch.expm1(-0.5 * z), rho)
  rho = torch.where(alpha == 0.0, log1p_safe(0.5 * z), rho)
  rho = torch.where(alpha == 2.0, 0.5 * z, rho)
  return scale * rho
