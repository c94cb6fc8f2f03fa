"""The nerfies on-disk capture format.

Port of nerfies_tpu/datasets/nerfies.py. Directory layout:

  data_dir/
    dataset.json          {'train_ids': [...], 'val_ids': [...]}
    scene.json            {'center': [x,y,z], 'scale': s, 'near': n, 'far': f}
    metadata.json         {item_id: {'appearance_id', 'camera_id', 'warp_id',
                                     'time_id'?}}
    rgb/{scale}x/*.png
    camera/*.json
    camera-paths/<name>/*.json   (novel-view trajectories)
    points.npy            background points (world coordinates)
"""

import json
from typing import List, Tuple

import numpy as np

from nerfies_tpu_torch import gpath
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import utils
from nerfies_tpu_torch.datasets import core


def load_scene_info(data_dir) -> Tuple[np.ndarray, float, float, float]:
  """Reads scene.json: (center, scale, near, far)."""
  scene_json_path = gpath.GPath(data_dir, 'scene.json')
  with scene_json_path.open('r') as f:
    scene_json = json.load(f)
  scene_center = np.array(scene_json['center'])
  scene_scale = scene_json['scale']
  near = scene_json['near']
  far = scene_json['far']
  return scene_center, scene_scale, near, far


def _load_dataset_ids(data_dir) -> Tuple[List[str], List[str]]:
  dataset_json_path = gpath.GPath(data_dir, 'dataset.json')
  with dataset_json_path.open('r') as f:
    dataset_json = json.load(f)
  train_ids = [str(i) for i in dataset_json['train_ids']]
  val_ids = [str(i) for i in dataset_json['val_ids']]
  return train_ids, val_ids


class NerfiesDataSource(core.DataSource):
  """Datasource over a nerfies-format capture directory."""

  def __init__(self,
               data_dir,
               image_scale: int,
               shuffle_pixels=False,
               camera_type='json',
               test_camera_trajectory='orbit-extreme',
               **kwargs):
    self.data_dir = gpath.GPath(data_dir)
    train_ids, val_ids = _load_dataset_ids(self.data_dir)
    super().__init__(train_ids=train_ids, val_ids=val_ids, **kwargs)
    self.scene_center, self.scene_scale, self._near, self._far = (
        load_scene_info(self.data_dir))
    self.test_camera_trajectory = test_camera_trajectory

    self.image_scale = image_scale
    self.shuffle_pixels = shuffle_pixels

    self.rgb_dir = gpath.GPath(data_dir, 'rgb', f'{image_scale}x')
    self.depth_dir = gpath.GPath(data_dir, 'depth', f'{image_scale}x')
    if camera_type not in ('json',):
      raise ValueError(f'Unknown camera_type {camera_type!r}')
    self.camera_type = camera_type
    self.camera_dir = gpath.GPath(data_dir, 'camera')

    metadata_path = self.data_dir / 'metadata.json'
    self.metadata_dict = None
    if metadata_path.exists():
      with metadata_path.open('r') as f:
        self.metadata_dict = json.load(f)

  @property
  def near(self) -> float:
    return self._near

  @property
  def far(self) -> float:
    return self._far

  @property
  def camera_ext(self) -> str:
    return '.json'

  def get_rgb_path(self, item_id):
    return self.rgb_dir / f'{item_id}.png'

  def load_rgb(self, item_id) -> np.ndarray:
    path = self.rgb_dir / f'{item_id}.png'
    return image_utils.image_to_float32(image_utils.load_image(path))[..., :3]

  def load_depth(self, item_id):
    """GT depth in scene units, or None when this frame has no depth map.

    Captures with depth/{scale}x/{id}.png uint16 maps feed eval's
    depth-MAE. Raw depth is metric, cameras are
    rescaled into scene units by `scene_scale`, so depth scales the same
    way.
    """
    path = self.depth_dir / f'{item_id}.png'
    if not path.exists():
      return None
    return image_utils.load_depth(path) * self.scene_scale

  def load_camera(self, item_id, scale_factor=1.0):
    if hasattr(item_id, 'suffix'):  # a path-like to a camera json
      camera_path = item_id
    else:
      camera_path = self.camera_dir / f'{item_id}{self.camera_ext}'
    return core.load_camera(
        camera_path,
        scale_factor=scale_factor / self.image_scale,
        scene_center=self.scene_center,
        scene_scale=self.scene_scale)

  def glob_cameras(self, path):
    path = gpath.GPath(path)
    return sorted(path.glob(f'*{self.camera_ext}'), key=str)

  def load_test_cameras(self, count=None):
    camera_dir = (self.data_dir / 'camera-paths' /
                  self.test_camera_trajectory)
    if not camera_dir.exists():
      return []
    camera_paths = sorted(camera_dir.glob(f'*{self.camera_ext}'), key=str)
    if count is not None:
      if count <= 0:
        return []
      stride = max(1, len(camera_paths) // count)
      camera_paths = camera_paths[::stride]
    return utils.parallel_map(self.load_camera, camera_paths)

  def load_points(self, shuffle=False) -> np.ndarray:
    """Background points, centered+scaled into scene coordinates."""
    with (self.data_dir / 'points.npy').open('rb') as f:
      points = np.load(f)
    points = (points - self.scene_center) * self.scene_scale
    points = points.astype(np.float32)
    if shuffle:
      shuffled_inds = self.rng.permutation(len(points))
      points = points[shuffled_inds]
    return points

  def get_appearance_id(self, item_id):
    return self.metadata_dict[item_id]['appearance_id']

  def get_camera_id(self, item_id):
    return self.metadata_dict[item_id]['camera_id']

  def get_warp_id(self, item_id):
    return self.metadata_dict[item_id]['warp_id']

  def get_time_id(self, item_id):
    if 'time_id' in self.metadata_dict[item_id]:
      return self.metadata_dict[item_id]['time_id']
    # Older captures key time by the warp id.
    return self.metadata_dict[item_id]['warp_id']
