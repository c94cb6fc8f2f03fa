"""Batched quaternion algebra on tensors (xyzw convention).

Port of nerfies_tpu/ops/quaternion.py. Quaternions are ``(..., 4)``
tensors with the imaginary part first: ``q = (x, y, z, w)``; every
function broadcasts over the leading dimensions.
"""

import torch


def safe_acos(t: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
  """arccos with input clipped away from +-1 to keep gradients finite."""
  return torch.arccos(torch.clamp(t, -1.0 + eps, 1.0 - eps))


def im(q: torch.Tensor) -> torch.Tensor:
  """Imaginary (vector) part of q."""
  return q[..., :3]


def re(q: torch.Tensor) -> torch.Tensor:
  """Real (scalar) part of q."""
  return q[..., 3:]


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
  return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def conjugate(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([-im(q), re(q)], dim=-1)


def norm(q: torch.Tensor) -> torch.Tensor:
  return torch.linalg.norm(q, dim=-1, keepdim=True)


def normalize(q: torch.Tensor) -> torch.Tensor:
  return q / norm(q)


def inverse(q: torch.Tensor) -> torch.Tensor:
  return conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """Hamilton product of two quaternion tensors."""
  c = (re(q1) * im(q2) + re(q2) * im(q1)
       + torch.linalg.cross(im(q1), im(q2), dim=-1))
  w = re(q1) * re(q2) - torch.sum(im(q1) * im(q2), dim=-1, keepdim=True)
  return torch.cat([c, w], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotates vectors v by unit quaternions q.

    v' = v + 2 w (u x v) + 2 u x (u x v),  u = im(q), w = re(q).
  """
  u = im(q)
  w = re(q)
  uxv = torch.linalg.cross(u, v, dim=-1)
  return v + 2.0 * (w * uxv + torch.linalg.cross(u, uxv, dim=-1))


def log(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
  """Quaternion logarithm (maps unit quaternions to pure quaternions)."""
  mag = norm(q)
  v = im(q)
  s = re(q)
  w = torch.log(mag)
  denom = torch.maximum(torch.linalg.norm(v, dim=-1, keepdim=True),
                        eps * torch.ones_like(v[..., :1]))
  xyz = v / denom * safe_acos(s / torch.clamp(mag, min=eps))
  return torch.cat([xyz, w], dim=-1)


def exp(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
  """Quaternion exponential (maps pure quaternions to unit quaternions)."""
  v = im(q)
  s = re(q)
  norm_v = torch.maximum(torch.linalg.norm(v, dim=-1, keepdim=True),
                         eps * torch.ones_like(v[..., :1]))
  scale = torch.exp(s)
  xyz = scale * v / norm_v * torch.sin(norm_v)
  w = scale * torch.cos(norm_v)
  return torch.cat([xyz, w], dim=-1)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
  """Converts unit quaternions (..., 4) to rotation matrices (..., 3, 3)."""
  x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
  row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
  row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
  return torch.stack([row0, row1, row2], dim=-2)


def from_rotation_matrix(m: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
  """Converts rotation matrices (..., 3, 3) to unit quaternions (..., 4).

  Branch-free Shepperd's method: all four candidate quaternions are
  computed and the numerically best one is selected per matrix with
  `where`, as in the JAX package.
  """
  m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
  m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
  m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

  tr = m00 + m11 + m22

  def _case(s_sq, build):
    s = torch.sqrt(torch.clamp(s_sq, min=eps))
    return build(s)

  # Case 0: trace positive.
  q0 = _case(tr + 1.0, lambda s: torch.stack([
      (m21 - m12) / (2 * s), (m02 - m20) / (2 * s), (m10 - m01) / (2 * s),
      0.5 * s], dim=-1))
  # Case 1: m00 dominant.
  q1 = _case(1.0 + m00 - m11 - m22, lambda s: torch.stack([
      0.5 * s, (m01 + m10) / (2 * s), (m02 + m20) / (2 * s),
      (m21 - m12) / (2 * s)], dim=-1))
  # Case 2: m11 dominant.
  q2 = _case(1.0 + m11 - m00 - m22, lambda s: torch.stack([
      (m01 + m10) / (2 * s), 0.5 * s, (m12 + m21) / (2 * s),
      (m02 - m20) / (2 * s)], dim=-1))
  # Case 3: m22 dominant.
  q3 = _case(1.0 + m22 - m00 - m11, lambda s: torch.stack([
      (m02 + m20) / (2 * s), (m12 + m21) / (2 * s), 0.5 * s,
      (m10 - m01) / (2 * s)], dim=-1))

  cond0 = (tr > 0.0)[..., None]
  cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
  cond2 = (m11 >= m22)[..., None]
  q = torch.where(cond0, q0, torch.where(cond1, q1,
                                         torch.where(cond2, q2, q3)))
  return normalize(q)
