"""COLMAP camera models: parameter layouts, projection, undistortion.

Implements the COLMAP camera-model zoo from the public format spec
(src/colmap/sensor/models.h). Copy of nerfies_tpu/colmap/camera.py.
"""

from typing import Dict, Tuple

import numpy as np
from scipy import optimize

# model_id -> (name, num_params). Parameter orders follow COLMAP.
CAMERA_MODELS: Dict[int, Tuple[str, int]] = {
    0: ('SIMPLE_PINHOLE', 3),      # f, cx, cy
    1: ('PINHOLE', 4),             # fx, fy, cx, cy
    2: ('SIMPLE_RADIAL', 4),       # f, cx, cy, k
    3: ('RADIAL', 5),              # f, cx, cy, k1, k2
    4: ('OPENCV', 8),              # fx, fy, cx, cy, k1, k2, p1, p2
    5: ('OPENCV_FISHEYE', 8),      # fx, fy, cx, cy, k1, k2, k3, k4
    6: ('FULL_OPENCV', 12),        # fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6
    7: ('FOV', 5),                 # fx, fy, cx, cy, omega
    8: ('SIMPLE_RADIAL_FISHEYE', 4),
    9: ('RADIAL_FISHEYE', 5),
    10: ('THIN_PRISM_FISHEYE', 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NUM_PARAMS = {mid: n for mid, (_, n) in CAMERA_MODELS.items()}


class ColmapCamera:
  """A COLMAP camera record with model-aware intrinsics."""

  def __init__(self, camera_id: int, model, width: int, height: int, params):
    self.camera_id = int(camera_id)
    if isinstance(model, str):
      self.model_id = CAMERA_MODEL_IDS[model]
    else:
      self.model_id = int(model)
    self.width = int(width)
    self.height = int(height)
    self.params = np.asarray(params, np.float64)
    expected = CAMERA_MODEL_NUM_PARAMS[self.model_id]
    if self.params.shape[0] != expected:
      raise ValueError(
          f'{self.model_name} expects {expected} params, got '
          f'{self.params.shape[0]}')

  @property
  def model_name(self) -> str:
    return CAMERA_MODELS[self.model_id][0]

  # --- intrinsics accessors ---

  @property
  def focal(self) -> Tuple[float, float]:
    name = self.model_name
    if name in ('SIMPLE_PINHOLE', 'SIMPLE_RADIAL', 'RADIAL',
                'SIMPLE_RADIAL_FISHEYE', 'RADIAL_FISHEYE'):
      return float(self.params[0]), float(self.params[0])
    return float(self.params[0]), float(self.params[1])

  @property
  def principal_point(self) -> Tuple[float, float]:
    name = self.model_name
    if name in ('SIMPLE_PINHOLE', 'SIMPLE_RADIAL', 'RADIAL',
                'SIMPLE_RADIAL_FISHEYE', 'RADIAL_FISHEYE'):
      return float(self.params[1]), float(self.params[2])
    return float(self.params[2]), float(self.params[3])

  @property
  def distortion(self) -> np.ndarray:
    """(k1, k2, p1, p2, k3) OpenCV-style coefficients (zeros if absent)."""
    name = self.model_name
    out = np.zeros(5)
    if name in ('SIMPLE_RADIAL', 'SIMPLE_RADIAL_FISHEYE'):
      out[0] = self.params[3]
    elif name in ('RADIAL', 'RADIAL_FISHEYE'):
      out[0], out[1] = self.params[3], self.params[4]
    elif name == 'OPENCV':
      out[:4] = self.params[4:8]
    elif name == 'FULL_OPENCV':
      out[0], out[1] = self.params[4], self.params[5]
      out[2], out[3] = self.params[6], self.params[7]
      out[4] = self.params[8]
    return out

  def get_camera_matrix(self) -> np.ndarray:
    fx, fy = self.focal
    cx, cy = self.principal_point
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

  # --- projection ---

  def _distort_normalized(self, xy: np.ndarray) -> np.ndarray:
    k1, k2, p1, p2, k3 = self.distortion
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
    xd = (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
    yd = (y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y))
    return np.stack([xd, yd], axis=-1)

  def world_to_image(self, points_camera: np.ndarray) -> np.ndarray:
    """Projects camera-frame points (..., 3) to pixels (..., 2)."""
    xy = points_camera[..., :2] / points_camera[..., 2:]
    xy = self._distort_normalized(xy)
    fx, fy = self.focal
    cx, cy = self.principal_point
    return np.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], axis=-1)

  def image_to_normalized(self, pixels: np.ndarray,
                          undistort: bool = True) -> np.ndarray:
    """Pixels (..., 2) -> undistorted normalized image coords (..., 2)."""
    fx, fy = self.focal
    cx, cy = self.principal_point
    xy = np.stack([(pixels[..., 0] - cx) / fx,
                   (pixels[..., 1] - cy) / fy], axis=-1)
    if not undistort or not np.any(self.distortion):
      return xy
    return self._undistort(xy)

  def _undistort(self, xy_distorted: np.ndarray) -> np.ndarray:
    shape = xy_distorted.shape
    flat = xy_distorted.reshape(-1, 2)

    def residual(xy_flat):
      xy = xy_flat.reshape(-1, 2)
      return (self._distort_normalized(xy) - flat).ravel()

    solution = optimize.root(residual, flat.ravel(), method='lm',
                             options={'maxiter': 50})
    return solution.x.reshape(shape)


  @property
  def num_params(self) -> int:
    return CAMERA_MODEL_NUM_PARAMS[self.model_id]

  def get_inverse_camera_matrix(self) -> np.ndarray:
    """K^-1 in closed form (upper-triangular intrinsics)."""
    fx, fy = self.focal
    cx, cy = self.principal_point
    return np.array([[1.0 / fx, 0.0, -cx / fx],
                     [0.0, 1.0 / fy, -cy / fy],
                     [0.0, 0.0, 1.0]])

  def distort_points(self, pixels: np.ndarray) -> np.ndarray:
    """Ideal (pinhole) pixels (..., 2) -> distorted observed pixels."""
    fx, fy = self.focal
    cx, cy = self.principal_point
    xy = np.stack([(pixels[..., 0] - cx) / fx,
                   (pixels[..., 1] - cy) / fy], axis=-1)
    xy = self._distort_normalized(xy)
    return np.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], axis=-1)

  def undistort_points(self, pixels: np.ndarray) -> np.ndarray:
    """Distorted observed pixels (..., 2) -> ideal pinhole pixels."""
    xy = self.image_to_normalized(pixels, undistort=True)
    fx, fy = self.focal
    cx, cy = self.principal_point
    return np.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], axis=-1)

  def get_image_grid(self, undistort: bool = True) -> np.ndarray:
    """(H, W, 2) normalized camera coords for every pixel center."""
    u, v = np.meshgrid(np.arange(self.width, dtype=np.float64) + 0.5,
                       np.arange(self.height, dtype=np.float64) + 0.5)
    pixels = np.stack([u, v], axis=-1)
    return self.image_to_normalized(pixels, undistort=undistort)

  def __repr__(self):
    return (f'ColmapCamera(id={self.camera_id}, model={self.model_name}, '
            f'{self.width}x{self.height})')
