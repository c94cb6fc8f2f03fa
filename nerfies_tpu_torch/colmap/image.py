"""COLMAP image (pose) records."""

import numpy as np

from nerfies_tpu_torch.colmap.rotation import Quaternion


class Image:
  """One registered image: pose (world->camera) + 2D observations."""

  def __init__(self, image_id, name, camera_id, qvec, tvec,
               points2D=None, point3D_ids=None):
    self.image_id = int(image_id)
    self.name = str(name)
    self.camera_id = int(camera_id)
    self.qvec = np.asarray(qvec, np.float64)  # (w, x, y, z)
    self.tvec = np.asarray(tvec, np.float64)
    self.points2D = (np.zeros((0, 2)) if points2D is None
                     else np.asarray(points2D, np.float64))
    self.point3D_ids = (np.zeros((0,), np.int64) if point3D_ids is None
                        else np.asarray(point3D_ids, np.int64))

  def R(self) -> np.ndarray:
    """World-to-camera rotation matrix."""
    return Quaternion(self.qvec).to_rotation_matrix()

  def C(self) -> np.ndarray:
    """Camera center in world coordinates: -R^T t."""
    return -self.R().T @ self.tvec

  def __repr__(self):
    return (f'Image(id={self.image_id}, name={self.name!r}, '
            f'camera_id={self.camera_id})')
