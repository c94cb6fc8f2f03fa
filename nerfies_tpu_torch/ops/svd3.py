"""Closed-form batched 3x3 spectral ops.

Port of nerfies_tpu/ops/svd3.py, with its LEADING layout: matrices are
(3, 3, ...), entry J[i, j] the (...)-shaped tensor d out_i / d in_j, and
vectors (3, ...). Every function is branch-free elementwise arithmetic
over the trailing dims, and differentiable.
"""

import math

import torch


def from_trailing(J: torch.Tensor) -> torch.Tensor:
  """(..., 3, 3) -> (3, 3, ...)."""
  return torch.movedim(J, (-2, -1), (0, 1))


def to_trailing(J: torch.Tensor) -> torch.Tensor:
  """(3, 3, ...) -> (..., 3, 3)."""
  return torch.movedim(J, (0, 1), (-2, -1))


def _eigvals_sym3_entries(a00, a11, a22, a01, a02, a12, eps=1e-12):
  """Eigenvalues, (3, ...) descending, of symmetric 3x3 matrices given by
  their 6 unique entries: the trigonometric solution of the cubic."""
  q = (a00 + a11 + a22) / 3.0
  p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
  p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
  p = torch.sqrt(torch.clamp(p2, min=eps) / 6.0)
  b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
  b01, b02, b12 = a01 / p, a02 / p, a12 / p
  det_b = (b00 * (b11 * b22 - b12 * b12)
           - b01 * (b01 * b22 - b12 * b02)
           + b02 * (b01 * b12 - b11 * b02))
  r = torch.clamp(det_b / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
  phi = torch.arccos(r) / 3.0
  e1 = q + 2.0 * p * torch.cos(phi)
  e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
  e2 = 3.0 * q - e1 - e3
  degenerate = (p2 < eps)[None]
  return torch.where(degenerate, torch.stack([q, q, q]),
                     torch.stack([e1, e2, e3]))


def _eigvals_sym3(A, eps=1e-12):
  return _eigvals_sym3_entries(A[0, 0], A[1, 1], A[2, 2], A[0, 1], A[0, 2],
                               A[1, 2], eps=eps)


def _jtj_entries(J):
  """(m00, m11, m22, m01, m02, m12) of J^T J."""
  def dot(j, k):
    return J[0, j] * J[0, k] + J[1, j] * J[1, k] + J[2, j] * J[2, k]
  return (dot(0, 0), dot(1, 1), dot(2, 2), dot(0, 1), dot(0, 2), dot(1, 2))


def _jtj(J):
  m00, m11, m22, m01, m02, m12 = _jtj_entries(J)
  return torch.stack([torch.stack([m00, m01, m02]),
                      torch.stack([m01, m11, m12]),
                      torch.stack([m02, m12, m22])])


def svals3(J: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """Singular values of (3, 3, ...) matrices, descending, as (3, ...)."""
  eigs = _eigvals_sym3_entries(*_jtj_entries(J), eps=eps)
  return torch.sqrt(torch.clamp(eigs, min=eps))


def det3(J: torch.Tensor) -> torch.Tensor:
  """Determinant of (3, 3, ...) matrices, expanded."""
  a, b, c = J[0, 0], J[0, 1], J[0, 2]
  d, e, f = J[1, 0], J[1, 1], J[1, 2]
  g, h, i = J[2, 0], J[2, 1], J[2, 2]
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(J: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """Inverse of (3, 3, ...) matrices via the adjugate."""
  a, b, c = J[0, 0], J[0, 1], J[0, 2]
  d, e, f = J[1, 0], J[1, 1], J[1, 2]
  g, h, i = J[2, 0], J[2, 1], J[2, 2]
  A = e * i - f * h
  B = -(d * i - f * g)
  C = d * h - e * g
  det = a * A + b * B + c * C
  det = torch.where(torch.abs(det) < eps, torch.sign(det) * eps + eps, det)
  adj = torch.stack([
      torch.stack([A, -(b * i - c * h), b * f - c * e]),
      torch.stack([B, a * i - c * g, -(a * f - c * d)]),
      torch.stack([C, -(a * h - b * g), a * e - b * d]),
  ])
  return adj / det


def _cross0(u, v):
  """Cross product of (3, ...) vectors along the leading axis."""
  return torch.stack([u[1] * v[2] - u[2] * v[1],
                      u[2] * v[0] - u[0] * v[2],
                      u[0] * v[1] - u[1] * v[0]])


def _smallest_right_singular_vector(J, eps=1e-12):
  """Unit right singular vector of the smallest singular value, (3, ...)."""
  JtJ = _jtj(J)
  lam = _eigvals_sym3(JtJ, eps=eps)[2]
  eye = torch.eye(3, dtype=J.dtype, device=J.device).reshape(
      (3, 3) + (1,) * (J.dim() - 2))
  B = JtJ - lam * eye
  cands = torch.stack([_cross0(B[0], B[1]), _cross0(B[1], B[2]),
                       _cross0(B[2], B[0])])  # (cand, 3, ...)
  best = torch.argmax(torch.sum(cands ** 2, dim=1), dim=0)
  v = torch.gather(cands, 0, best[None, None].expand(1, *cands.shape[1:]))[0]
  return v / torch.sqrt(torch.clamp(torch.sum(v ** 2, dim=0, keepdim=True),
                                    min=eps))


def nearest_rotation(J: torch.Tensor, num_iters: int = 8) -> torch.Tensor:
  """Nearest rotation (det = +1) to (3, 3, ...) matrices, Frobenius norm.

  Determinant-scaled Newton iteration for the orthogonal polar factor,
  with a Householder flip along the smallest right singular vector where
  det(J) < 0 (svd3.py nearest_rotation).
  """
  X = J
  for _ in range(num_iters):
    mu = torch.clamp(torch.abs(det3(X)) ** (-1.0 / 3.0), 1e-4, 1e4)
    X = 0.5 * (mu * X + inv3(mu * X).transpose(0, 1))
  v = _smallest_right_singular_vector(J)
  Xv = torch.stack([X[i, 0] * v[0] + X[i, 1] * v[1] + X[i, 2] * v[2]
                    for i in range(3)])
  flipped = X - 2.0 * Xv[:, None] * v[None, :]
  return torch.where(det3(J) < 0, flipped, X)
