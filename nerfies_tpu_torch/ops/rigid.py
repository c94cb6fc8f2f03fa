"""Rigid-body motion from raw SE(3) twists (forward only).

Port of `se3_apply_raw` (nerfies_tpu/ops/rigid.py:134). Serving needs no
gradient, but each branch keeps its clamp and the Taylor switch so the
values match the reference at and around theta = 0.
"""

import torch


def se3_apply_raw(w: torch.Tensor, v: torch.Tensor,
                  points: torch.Tensor) -> torch.Tensor:
  """Applies exp([w, v]) to points from raw (unnormalised) twists.

    R p   = p + a (w x p) + b (w x (w x p)),   a = sin(t)/t,
    trans = v + b (w x v) + c (w x (w x v)),   b = (1-cos(t))/t^2,
                                               c = (t-sin(t))/t^3,

  with t = |w| and Taylor series below t < 0.1.

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
