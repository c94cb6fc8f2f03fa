"""Batched rigid-body (Lie group) operations.

Port of nerfies_tpu/ops/rigid.py: every op is batched over arbitrary
leading dimensions, on the device of its inputs. Conventions follow
Modern Robotics (Lynch & Park): `exp_so3` is Rodrigues' formula (MR eqn
3.51), `exp_se3` the screw-motion exponential (MR eqn 3.88).

The warp runs `se3_apply_raw`. The elastic loss differentiates through
its linearization, so it must have finite derivatives of every order at
and around theta = 0: the exact branch evaluates on an input clamped into
the region where it is selected, and a Taylor series takes over below
theta = 0.1, as in the reference. Plain autograd differentiates it twice.
"""

import torch


def skew(w: torch.Tensor) -> torch.Tensor:
  """The skew ("cross-product") matrices of `w`.

  Args:
    w: (..., 3) axis vectors.

  Returns:
    (..., 3, 3) matrices W with W @ v == w x v.
  """
  zeros = torch.zeros_like(w[..., 0])
  wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
  return torch.stack([torch.stack([zeros, -wz, wy], dim=-1),
                      torch.stack([wz, zeros, -wx], dim=-1),
                      torch.stack([-wy, wx, zeros], dim=-1)], dim=-2)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
  """so(3) -> SO(3) exponential map (Rodrigues' formula).

  Args:
    w: (..., 3) unit rotation axes.
    theta: (...,) rotation angles.

  Returns:
    (..., 3, 3) rotation matrices.
  """
  W = skew(w)
  eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
  return (eye + torch.sin(theta)[..., None, None] * W
          + (1.0 - torch.cos(theta))[..., None, None] * (W @ W))


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
  """se(3) -> SE(3) exponential map (MR eqn 3.88).

  Args:
    S: (..., 6) screw axes, split as (w, v) with |w| == 1.
    theta: (...,) motion magnitudes.

  Returns:
    (..., 4, 4) homogeneous transforms.
  """
  w, v = S[..., :3], S[..., 3:]
  W = skew(w)
  eye = torch.eye(3, dtype=S.dtype, device=S.device).expand(W.shape)
  G = (theta[..., None, None] * eye
       + (1.0 - torch.cos(theta))[..., None, None] * W
       + (theta - torch.sin(theta))[..., None, None] * (W @ W))
  return rp_to_se3(exp_so3(w, theta), (G @ v[..., None])[..., 0])


def rp_to_se3(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
  """Homogeneous transforms from (..., 3, 3) rotations and (..., 3)
  translations: (..., 4, 4)."""
  top = torch.cat([R, p[..., None]], dim=-1)
  bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                        device=R.device).expand(top.shape[:-2] + (1, 4))
  return torch.cat([top, bottom], dim=-2)


def se3_apply(S: torch.Tensor, theta: torch.Tensor,
              points: torch.Tensor) -> torch.Tensor:
  """Applies `exp_se3(S, theta)` to points without forming 4x4 matrices.

  The fused form of ``from_homogenous(exp_se3(S, theta) @
  to_homogenous(p))``: the bottom row is exactly [0, 0, 0, 1], so

    R p   = p + sin(t) (w x p) + (1-cos(t)) (w x (w x p))
    trans = t v + (1-cos(t)) (w x v) + (t - sin(t)) (w x (w x v))

  Args:
    S: (..., 6) screw axes (w unit-norm).
    theta: (...,) magnitudes.
    points: (..., 3) points.

  Returns:
    (..., 3) transformed points.
  """
  w, v = S[..., :3], S[..., 3:]
  sin = torch.sin(theta)[..., None]
  cos1 = (1.0 - torch.cos(theta))[..., None]
  tms = (theta - torch.sin(theta))[..., None]
  wxp = torch.linalg.cross(w, points, dim=-1)
  wwxp = torch.linalg.cross(w, wxp, dim=-1)
  rotated = points + sin * wxp + cos1 * wwxp
  wxv = torch.linalg.cross(w, v, dim=-1)
  wwxv = torch.linalg.cross(w, wxv, dim=-1)
  translation = theta[..., None] * v + cos1 * wxv + tms * wwxv
  return rotated + translation


def to_homogenous(v: torch.Tensor) -> torch.Tensor:
  return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def from_homogenous(v: torch.Tensor) -> torch.Tensor:
  return v[..., :3] / v[..., -1:]


def se3_apply_raw(w: torch.Tensor, v: torch.Tensor,
                  points: torch.Tensor) -> torch.Tensor:
  """Applies exp([w, v]) to points from raw (unnormalised) twists.

  ``se3_apply(concat([w, v]) / |w|, |w|, points)`` for |w| > 0, in
  sinc-style coefficients of t = |w|:

    R p   = p + a (w x p) + b (w x (w x p)),   a = sin(t)/t,
    trans = v + b (w x v) + c (w x (w x v)),   b = (1-cos(t))/t^2,
                                               c = (t-sin(t))/t^3,

  with Taylor series below t < 0.1: at w = 0 the transform is exactly the
  translation by v, with finite derivatives.

  Args:
    w: (..., 3) rotation twists (|w| is the angle).
    v: (..., 3) translation twists.
    points: (..., 3).

  Returns:
    (..., 3) transformed points.
  """
  theta_sq = torch.sum(w * w, dim=-1)
  # The exact branch is evaluated on an input clamped into the region
  # where it is selected, as in the reference.
  theta_sq_safe = torch.clamp(theta_sq, min=0.005)
  theta = torch.sqrt(theta_sq_safe)
  sin_t = torch.sin(theta)
  a_exact = sin_t / theta
  half_sin = torch.sin(0.5 * theta)
  b_exact = 2.0 * half_sin * half_sin / theta_sq_safe
  c_exact = (theta - sin_t) / (theta_sq_safe * theta)

  small = theta_sq < 0.01
  t2 = theta_sq
  a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, a_exact)[..., None]
  b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, b_exact)[..., None]
  c = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                  c_exact)[..., None]

  wxp = torch.linalg.cross(w, points, dim=-1)
  wwxp = torch.linalg.cross(w, wxp, dim=-1)
  rotated = points + a * wxp + b * wwxp
  wxv = torch.linalg.cross(w, v, dim=-1)
  wwxv = torch.linalg.cross(w, wxv, dim=-1)
  translation = v + b * wxv + c * wwxv
  return rotated + translation
