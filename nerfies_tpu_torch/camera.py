"""OpenCV-model camera: intrinsics, distortion, ray generation.

Port of nerfies_tpu/camera.py. Two compute paths:

  - the `Camera` class: vectorized numpy, used on the host by the data
    layer (JSON in and out, iterative undistortion, project and
    pixels_to_rays, scale, crop and look_at);
  - `pixels_to_rays` / `undistort`: batched functions of tensors, on any
    device, for ray generation next to the model (the JAX package runs
    them under jit with the Newton solve in `lax.fori_loop`; here the ten
    iterations are a Python loop).
"""

import copy
import json
from typing import Optional, Tuple, Union

import numpy as np
import torch

UNDISTORT_ITERATIONS = 10
_UNDISTORT_EPS = 1e-9


def _distort_residual_and_jacobian(x, y, xd, yd, k1, k2, k3, p1, p2, xp):
  """Residual of the distortion map and its 2x2 Jacobian (batched).

  The forward distortion model (OpenCV):
    r = x^2 + y^2; d = 1 + k1 r + k2 r^2 + k3 r^3
    xd = x d + 2 p1 x y + p2 (r + 2 x^2)
    yd = y d + 2 p2 x y + p1 (r + 2 y^2)
  Returns fx, fy (residuals vs the observed xd, yd) and the four partials.
  Works for numpy arrays and tensors (`xp` is numpy or torch).
  """
  r = x * x + y * y
  d = 1.0 + r * (k1 + r * (k2 + k3 * r))

  fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
  fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd

  d_r = k1 + r * (2.0 * k2 + 3.0 * k3 * r)
  d_x = 2.0 * x * d_r
  d_y = 2.0 * y * d_r

  fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
  fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
  fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
  fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
  del xp
  return fx, fy, fx_x, fx_y, fy_x, fy_y


def _newton_step(x, y, xd, yd, dist, xp):
  k1, k2, k3, p1, p2 = dist
  fx, fy, fx_x, fx_y, fy_x, fy_y = _distort_residual_and_jacobian(
      x, y, xd, yd, k1, k2, k3, p1, p2, xp)
  denominator = fy_x * fx_y - fx_x * fy_y
  x_numerator = fx * fy_y - fy * fx_y
  y_numerator = fy * fx_x - fx * fy_x
  safe = xp.abs(denominator) > _UNDISTORT_EPS
  step_x = xp.where(safe, x_numerator / denominator, xp.zeros_like(x))
  step_y = xp.where(safe, y_numerator / denominator, xp.zeros_like(y))
  return x + step_x, y + step_y


def undistort_np(xd, yd, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0,
                 max_iterations=UNDISTORT_ITERATIONS):
  """Numpy Newton undistortion (the host path)."""
  x, y = xd.copy(), yd.copy()
  for _ in range(max_iterations):
    x, y = _newton_step(x, y, xd, yd, (k1, k2, k3, p1, p2), np)
  return x, y


def undistort(xd: torch.Tensor, yd: torch.Tensor, radial: torch.Tensor,
              tangential: torch.Tensor,
              max_iterations: int = UNDISTORT_ITERATIONS):
  """Batched Newton undistortion of tensors (the device path)."""
  dist = (radial[..., 0], radial[..., 1], radial[..., 2],
          tangential[..., 0], tangential[..., 1])
  x, y = xd, yd
  for _ in range(max_iterations):
    x, y = _newton_step(x, y, xd, yd, dist, torch)
  return x, y


def pixels_to_rays(pixels: torch.Tensor, orientation: torch.Tensor,
                   position: torch.Tensor, focal_length: torch.Tensor,
                   principal_point: torch.Tensor, skew: torch.Tensor,
                   pixel_aspect_ratio: torch.Tensor,
                   radial_distortion: torch.Tensor,
                   tangential_distortion: torch.Tensor):
  """Batched ray generation on tensors: pixels -> world-space unit rays.

  All camera parameters broadcast against the pixel batch, so one call
  serves one camera over a full image or a ragged batch of (pixel,
  camera) pairs (origins come from `position`).

  Args:
    pixels: (..., 2) pixel centers.
    orientation: (..., 3, 3) world-to-camera rotation.
    position: (..., 3) camera position (= ray origins).
    focal_length: (...,) focal length in pixels.
    principal_point: (..., 2).
    skew: (...,).
    pixel_aspect_ratio: (...,).
    radial_distortion: (..., 3) k1 k2 k3.
    tangential_distortion: (..., 2) p1 p2.

  Returns:
    directions: (..., 3) unit ray directions in world space.
  """
  del position
  y = (pixels[..., 1] - principal_point[..., 1]) / (
      focal_length * pixel_aspect_ratio)
  x = (pixels[..., 0] - principal_point[..., 0] - y * skew) / focal_length
  x, y = undistort(x, y, radial_distortion, tangential_distortion)
  dirs = torch.stack([x, y, torch.ones_like(x)], dim=-1)
  dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
  # Local -> world: R^T @ d, as an elementwise product and a sum over j,
  # which gives a ray the same bits in a batch of any size (a matmul's
  # summation order depends on the batch size).
  dirs = (orientation * dirs[..., :, None]).sum(dim=-2)
  return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


class Camera:
  """An OpenCV-model camera (host-side numpy).

  JSON round-trip compatible with the reference capture format
  (camera/*.json written by the capture-processing pipeline).
  """

  def __init__(self,
               orientation: np.ndarray,
               position: np.ndarray,
               focal_length: Union[np.ndarray, float],
               principal_point: np.ndarray,
               image_size: np.ndarray,
               skew: Union[np.ndarray, float] = 0.0,
               pixel_aspect_ratio: Union[np.ndarray, float] = 1.0,
               radial_distortion: Optional[np.ndarray] = None,
               tangential_distortion: Optional[np.ndarray] = None,
               dtype=np.float32):
    if radial_distortion is None:
      radial_distortion = np.array([0.0, 0.0, 0.0], dtype)
    if tangential_distortion is None:
      tangential_distortion = np.array([0.0, 0.0], dtype)

    self.orientation = np.array(orientation, dtype)
    self.position = np.array(position, dtype)
    self.focal_length = np.array(focal_length, dtype)
    self.principal_point = np.array(principal_point, dtype)
    self.skew = np.array(skew, dtype)
    self.pixel_aspect_ratio = np.array(pixel_aspect_ratio, dtype)
    self.radial_distortion = np.array(radial_distortion, dtype)
    self.tangential_distortion = np.array(tangential_distortion, dtype)
    self.image_size = np.array(image_size, np.uint32)
    self.dtype = dtype

  # --- serialization ---

  @classmethod
  def from_json(cls, path) -> 'Camera':
    with open(path, 'r') as fp:
      camera_json = json.load(fp)
    return cls.from_dict(camera_json)

  @classmethod
  def from_dict(cls, camera_json: dict) -> 'Camera':
    # Legacy field name used by early capture exports.
    if 'tangential' in camera_json:
      camera_json['tangential_distortion'] = camera_json['tangential']
    return cls(
        orientation=np.asarray(camera_json['orientation']),
        position=np.asarray(camera_json['position']),
        focal_length=camera_json['focal_length'],
        principal_point=np.asarray(camera_json['principal_point']),
        skew=camera_json['skew'],
        pixel_aspect_ratio=camera_json['pixel_aspect_ratio'],
        radial_distortion=np.asarray(camera_json['radial_distortion']),
        tangential_distortion=np.asarray(camera_json['tangential_distortion']),
        image_size=np.asarray(camera_json['image_size']),
    )

  def to_json(self) -> dict:
    return {
        k: (v.tolist() if hasattr(v, 'tolist') else v)
        for k, v in self.get_parameters().items()
    }

  def save_json(self, path) -> None:
    with open(path, 'w') as fp:
      json.dump(self.to_json(), fp, indent=2)

  def get_parameters(self) -> dict:
    return {
        'orientation': self.orientation,
        'position': self.position,
        'focal_length': self.focal_length,
        'principal_point': self.principal_point,
        'skew': self.skew,
        'pixel_aspect_ratio': self.pixel_aspect_ratio,
        'radial_distortion': self.radial_distortion,
        'tangential_distortion': self.tangential_distortion,
        'image_size': self.image_size,
    }

  def ray_parameters(self) -> dict:
    """Parameters of the tensor `pixels_to_rays`."""
    return {
        'orientation': self.orientation,
        'position': self.position,
        'focal_length': self.focal_length,
        'principal_point': self.principal_point,
        'skew': self.skew,
        'pixel_aspect_ratio': self.pixel_aspect_ratio,
        'radial_distortion': self.radial_distortion,
        'tangential_distortion': self.tangential_distortion,
    }

  # --- derived properties ---

  @property
  def scale_factor_x(self):
    return self.focal_length

  @property
  def scale_factor_y(self):
    return self.focal_length * self.pixel_aspect_ratio

  @property
  def principal_point_x(self):
    return self.principal_point[0]

  @property
  def principal_point_y(self):
    return self.principal_point[1]

  @property
  def has_tangential_distortion(self):
    return any(self.tangential_distortion != 0.0)

  @property
  def has_radial_distortion(self):
    return any(self.radial_distortion != 0.0)

  @property
  def image_size_y(self):
    return int(self.image_size[1])

  @property
  def image_size_x(self):
    return int(self.image_size[0])

  @property
  def image_shape(self) -> Tuple[int, int]:
    return self.image_size_y, self.image_size_x

  @property
  def optical_axis(self):
    return self.orientation[2, :]

  @property
  def translation(self):
    return -np.matmul(self.orientation, self.position)

  # --- geometry ---

  def pixel_to_local_rays(self, pixels: np.ndarray) -> np.ndarray:
    """Camera-frame ray directions for pixel centers (..., 2) -> (..., 3)."""
    y = (pixels[..., 1] - self.principal_point_y) / self.scale_factor_y
    x = ((pixels[..., 0] - self.principal_point_x - y * self.skew) /
         self.scale_factor_x)
    if self.has_radial_distortion or self.has_tangential_distortion:
      x, y = undistort_np(
          x, y,
          k1=self.radial_distortion[0],
          k2=self.radial_distortion[1],
          k3=self.radial_distortion[2],
          p1=self.tangential_distortion[0],
          p2=self.tangential_distortion[1])
    dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

  def pixels_to_rays(self, pixels: np.ndarray) -> np.ndarray:
    """World-frame unit ray directions for pixel centers."""
    if pixels.shape[-1] != 2:
      raise ValueError('The last dimension of pixels must be 2.')
    if pixels.dtype != self.dtype:
      raise ValueError(f'pixels dtype ({pixels.dtype!r}) must match camera '
                       f'dtype ({self.dtype!r})')
    batch_shape = pixels.shape[:-1]
    pixels = np.reshape(pixels, (-1, 2))
    local_rays = self.pixel_to_local_rays(pixels)
    rays_dir = local_rays @ self.orientation  # == orientation.T @ d, batched
    rays_dir /= np.linalg.norm(rays_dir, axis=-1, keepdims=True)
    return rays_dir.reshape((*batch_shape, 3))

  def pixels_to_points(self, pixels: np.ndarray,
                       depth: np.ndarray) -> np.ndarray:
    rays = self.pixels_to_rays(pixels)
    cosa = rays @ self.optical_axis
    return rays * depth[..., None] / cosa[..., None] + self.position

  def points_to_local_points(self, points: np.ndarray) -> np.ndarray:
    return (points - self.position) @ self.orientation.T

  def project(self, points: np.ndarray) -> np.ndarray:
    """Projects world points (..., 3) to pixel positions (..., 2)."""
    batch_shape = points.shape[:-1]
    points = points.reshape((-1, 3))
    local_points = self.points_to_local_points(points)

    # Points at (or behind) the camera plane have no projection; guard
    # the divide so z<=0 points map to finite garbage instead of
    # RuntimeWarning-spewing inf/nan (callers mask by depth, and the
    # capture pipeline's visibility filtering tripped the warnings).
    z = local_points[..., 2]
    safe_z = np.where(np.abs(z) < 1e-8, 1e-8, z)
    x = local_points[..., 0] / safe_z
    y = local_points[..., 1] / safe_z
    r2 = x ** 2 + y ** 2

    k1, k2, k3 = self.radial_distortion
    p1, p2 = self.tangential_distortion
    distortion = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
    x_times_y = x * y
    xd = x * distortion + 2.0 * p1 * x_times_y + p2 * (r2 + 2.0 * x ** 2)
    yd = y * distortion + 2.0 * p2 * x_times_y + p1 * (r2 + 2.0 * y ** 2)

    pixel_x = self.focal_length * xd + self.skew * yd + self.principal_point_x
    pixel_y = (self.focal_length * self.pixel_aspect_ratio * yd
               + self.principal_point_y)
    pixels = np.stack([pixel_x, pixel_y], axis=-1)
    return pixels.reshape((*batch_shape, 2))

  def get_pixel_centers(self) -> np.ndarray:
    xx, yy = np.meshgrid(np.arange(self.image_size_x, dtype=self.dtype),
                         np.arange(self.image_size_y, dtype=self.dtype))
    return np.stack([xx, yy], axis=-1) + 0.5

  # --- camera manipulation ---

  def scale(self, scale: float) -> 'Camera':
    if scale <= 0:
      raise ValueError('scale needs to be positive.')
    return Camera(
        orientation=self.orientation.copy(),
        position=self.position.copy(),
        focal_length=self.focal_length * scale,
        principal_point=self.principal_point.copy() * scale,
        skew=self.skew,
        pixel_aspect_ratio=self.pixel_aspect_ratio,
        radial_distortion=self.radial_distortion.copy(),
        tangential_distortion=self.tangential_distortion.copy(),
        image_size=np.array((int(round(self.image_size[0] * scale)),
                             int(round(self.image_size[1] * scale)))),
    )

  def look_at(self, position, look_at, up, eps=1e-6) -> 'Camera':
    """Returns a copy positioned at `position` aimed at `look_at`."""
    camera = self.copy()
    optical_axis = look_at - position
    norm = np.linalg.norm(optical_axis)
    if norm < eps:
      raise ValueError('The camera center and look at position are too close.')
    optical_axis /= norm

    right = np.cross(optical_axis, up)
    norm = np.linalg.norm(right)
    if norm < eps:
      raise ValueError('The up-vector is parallel to the optical axis.')
    right /= norm

    rotation = np.identity(3)
    rotation[0, :] = right
    rotation[1, :] = np.cross(optical_axis, right)
    rotation[2, :] = optical_axis

    camera.position = np.asarray(position, dtype=self.dtype)
    camera.orientation = rotation.astype(self.dtype)
    return camera

  def crop_image_domain(self, left: int = 0, right: int = 0, top: int = 0,
                        bottom: int = 0) -> 'Camera':
    """Shrinks (or grows, if negative) the image bounds, keeping optics."""
    crop_left_top = np.array([left, top])
    crop_right_bottom = np.array([right, bottom])
    new_resolution = self.image_size - crop_left_top - crop_right_bottom
    new_principal_point = self.principal_point - crop_left_top
    if np.any(new_resolution <= 0):
      raise ValueError('Crop would result in non-positive image dimensions.')
    camera = self.copy()
    camera.image_size = np.array(
        [int(new_resolution[0]), int(new_resolution[1])], np.uint32)
    camera.principal_point = np.array(
        [new_principal_point[0], new_principal_point[1]], self.dtype)
    return camera

  def copy(self) -> 'Camera':
    return copy.deepcopy(self)
