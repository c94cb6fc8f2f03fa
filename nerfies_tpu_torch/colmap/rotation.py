"""Numpy quaternion / dual-quaternion pose algebra (COLMAP wxyz order)."""

import numpy as np


class Quaternion:
  """Unit quaternion in COLMAP's (w, x, y, z) storage order."""

  def __init__(self, q=(1.0, 0.0, 0.0, 0.0)):
    self.q = np.asarray(q, np.float64)

  @classmethod
  def from_rotation_matrix(cls, R) -> 'Quaternion':
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
      s = np.sqrt(tr + 1.0) * 2
      w = 0.25 * s
      x = (R[2, 1] - R[1, 2]) / s
      y = (R[0, 2] - R[2, 0]) / s
      z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
      s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
      w = (R[2, 1] - R[1, 2]) / s
      x = 0.25 * s
      y = (R[0, 1] + R[1, 0]) / s
      z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
      s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
      w = (R[0, 2] - R[2, 0]) / s
      x = (R[0, 1] + R[1, 0]) / s
      y = 0.25 * s
      z = (R[1, 2] + R[2, 1]) / s
    else:
      s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
      w = (R[1, 0] - R[0, 1]) / s
      x = (R[0, 2] + R[2, 0]) / s
      y = (R[1, 2] + R[2, 1]) / s
      z = 0.25 * s
    return cls((w, x, y, z))

  @classmethod
  def from_axis_angle(cls, axis, angle) -> 'Quaternion':
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * angle
    return cls((np.cos(half), *(np.sin(half) * axis)))

  def to_rotation_matrix(self) -> np.ndarray:
    w, x, y, z = self.normalized().q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])

  def normalized(self) -> 'Quaternion':
    return Quaternion(self.q / np.linalg.norm(self.q))

  def conjugate(self) -> 'Quaternion':
    w, x, y, z = self.q
    return Quaternion((w, -x, -y, -z))

  def __mul__(self, other: 'Quaternion') -> 'Quaternion':
    w1, x1, y1, z1 = self.q
    w2, x2, y2, z2 = other.q
    return Quaternion((
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ))

  def rotate(self, v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    qv = Quaternion((0.0, *v))
    return (self * qv * self.conjugate()).q[1:]

  def to_axis_angle(self):
    """(unit axis, angle in [0, pi]); axis is arbitrary at angle 0."""
    q = self.normalized()
    w = np.clip(q.q[0], -1.0, 1.0)
    angle = 2.0 * np.arccos(abs(w))
    v = q.q[1:] * (1.0 if w >= 0 else -1.0)
    norm = np.linalg.norm(v)
    axis = v / norm if norm > 1e-12 else np.array([1.0, 0.0, 0.0])
    return axis, float(angle)

  def to_euler_angles(self):
    """Intrinsic roll (x), pitch (y), yaw (z) from the rotation matrix."""
    R = self.to_rotation_matrix()
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    if abs(R[2, 0]) < 1.0 - 1e-9:
      roll = np.arctan2(R[2, 1], R[2, 2])
      yaw = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
      roll = np.arctan2(-R[1, 2], R[1, 1])
      yaw = 0.0
    return float(roll), float(pitch), float(yaw)

  def rotate_points(self, points) -> np.ndarray:
    """Rotates (N, 3) points via the rotation matrix (one matmul)."""
    return np.asarray(points, np.float64) @ self.to_rotation_matrix().T

  def __repr__(self):
    return f'Quaternion({self.q.tolist()})'


class DualQuaternion:
  """Rigid transform as a dual quaternion (rotation + translation)."""

  def __init__(self, real: Quaternion, dual: Quaternion):
    self.real = real
    self.dual = dual

  @classmethod
  def from_rt(cls, rotation: Quaternion, translation) -> 'DualQuaternion':
    t = np.asarray(translation, np.float64)
    dual = Quaternion((0.0, *t)) * rotation
    dual = Quaternion(0.5 * dual.q)
    return cls(rotation, dual)

  def to_rt(self):
    rotation = self.real.normalized()
    t_quat = Quaternion(2.0 * self.dual.q) * rotation.conjugate()
    return rotation, t_quat.q[1:]

  def transform(self, v) -> np.ndarray:
    rotation, translation = self.to_rt()
    return rotation.rotate(v) + translation

  def __mul__(self, other: 'DualQuaternion') -> 'DualQuaternion':
    real = self.real * other.real
    dual = Quaternion(
        (self.real * other.dual).q + (self.dual * other.real).q)
    return DualQuaternion(real, dual)


def cross_prod_matrix(v) -> np.ndarray:
  """Skew-symmetric [v]_x with [v]_x w = v x w."""
  x, y, z = np.asarray(v, np.float64)
  return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def axis_angle_to_rotation_matrix(axis, angle: float) -> np.ndarray:
  """Rodrigues' formula: R = I + sin(t) K + (1 - cos(t)) K^2."""
  axis = np.asarray(axis, np.float64)
  axis = axis / np.linalg.norm(axis)
  K = cross_prod_matrix(axis)
  return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def rotation_matrix_to_axis_angle(R):
  """Inverse Rodrigues: (unit axis, angle in [0, pi])."""
  return Quaternion.from_rotation_matrix(np.asarray(R)).to_axis_angle()
