"""COLMAP sparse-reconstruction IO: cameras/images/points3D, bin and txt.

Readers/writers implement the public COLMAP sparse-model format
(colmap/src/colmap/scene/reconstruction_io.cc):

  cameras.bin : u64 N; per camera: i32 id, i32 model_id, u64 w, u64 h,
                f64 params[num_params(model)]
  images.bin  : u64 N; per image: i32 id, f64 q[4] (wxyz), f64 t[3],
                i32 camera_id, name\\0, u64 n_pts; per pt: f64 x, f64 y,
                i64 point3D_id (-1 = unobserved)
  points3D.bin: u64 N; per point: u64 id, f64 xyz[3], u8 rgb[3], f64 err,
                u64 track_len; per track: i32 image_id, i32 point2D_idx

The port's copy of nerfies_tpu/colmap/scene_manager.py.
"""

import os
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from nerfies_tpu_torch.colmap.camera import CAMERA_MODEL_NUM_PARAMS
from nerfies_tpu_torch.colmap.camera import CAMERA_MODELS
from nerfies_tpu_torch.colmap.camera import ColmapCamera
from nerfies_tpu_torch.colmap.image import Image

INVALID_POINT3D = np.uint64(2 ** 64 - 1)


def _read(f, fmt):
  size = struct.calcsize(fmt)
  return struct.unpack(fmt, f.read(size))


class SceneManager:
  """Loads, filters, and saves a COLMAP sparse reconstruction."""

  def __init__(self, colmap_dir, image_path: Optional[str] = None):
    self.colmap_dir = Path(colmap_dir)
    self.image_path = image_path
    self.cameras: Dict[int, ColmapCamera] = {}
    self.images: Dict[int, Image] = {}
    self.name_to_image_id: Dict[str, int] = {}
    self.points3D = np.zeros((0, 3))
    self.point3D_ids = np.zeros((0,), np.uint64)
    self.point3D_id_to_point3D_idx: Dict[int, int] = {}
    self.point3D_colors = np.zeros((0, 3), np.uint8)
    self.point3D_errors = np.zeros((0,))
    # track info: per point, list of (image_id, point2D_idx)
    self.point3D_tracks = []

  def _path(self, name: str) -> Path:
    for candidate in (self.colmap_dir / name,
                      self.colmap_dir / 'sparse' / '0' / name):
      if candidate.exists():
        return candidate
    return self.colmap_dir / name

  # --- loading ---

  def load(self):
    self.load_cameras()
    self.load_images()
    self.load_points3D()
    return self

  def load_cameras(self):
    bin_path = self._path('cameras.bin')
    if bin_path.exists():
      self._load_cameras_bin(bin_path)
    else:
      self._load_cameras_txt(self._path('cameras.txt'))

  def _load_cameras_bin(self, path):
    with open(path, 'rb') as f:
      (num_cameras,) = _read(f, '<Q')
      for _ in range(num_cameras):
        camera_id, model_id, width, height = _read(f, '<iiQQ')
        num_params = CAMERA_MODEL_NUM_PARAMS[model_id]
        params = _read(f, f'<{num_params}d')
        self.cameras[camera_id] = ColmapCamera(
            camera_id, model_id, width, height, params)

  def _load_cameras_txt(self, path):
    with open(path, 'r') as f:
      for line in f:
        line = line.strip()
        if not line or line.startswith('#'):
          continue
        parts = line.split()
        camera_id = int(parts[0])
        model_name = parts[1]
        width, height = int(parts[2]), int(parts[3])
        params = [float(p) for p in parts[4:]]
        self.cameras[camera_id] = ColmapCamera(
            camera_id, model_name, width, height, params)

  def load_images(self):
    bin_path = self._path('images.bin')
    if bin_path.exists():
      self._load_images_bin(bin_path)
    else:
      self._load_images_txt(self._path('images.txt'))
    self.name_to_image_id = {
        image.name: image_id for image_id, image in self.images.items()}

  def _load_images_bin(self, path):
    with open(path, 'rb') as f:
      (num_images,) = _read(f, '<Q')
      for _ in range(num_images):
        (image_id,) = _read(f, '<i')
        qvec = np.asarray(_read(f, '<4d'))
        tvec = np.asarray(_read(f, '<3d'))
        (camera_id,) = _read(f, '<i')
        name_chars = []
        while True:
          c = f.read(1)
          if c == b'\x00':
            break
          name_chars.append(c)
        name = b''.join(name_chars).decode('utf-8')
        (num_points,) = _read(f, '<Q')
        data = np.frombuffer(
            f.read(24 * num_points),
            dtype=np.dtype([('x', '<f8'), ('y', '<f8'), ('id', '<i8')]))
        points2D = np.stack([data['x'], data['y']], axis=-1)
        self.images[image_id] = Image(
            image_id, name, camera_id, qvec, tvec, points2D, data['id'])

  def _load_images_txt(self, path):
    with open(path, 'r') as f:
      lines = [ln.strip() for ln in f
               if ln.strip() and not ln.startswith('#')]
    for header, pts in zip(lines[0::2], lines[1::2]):
      parts = header.split()
      image_id = int(parts[0])
      qvec = [float(v) for v in parts[1:5]]
      tvec = [float(v) for v in parts[5:8]]
      camera_id = int(parts[8])
      name = parts[9]
      tokens = pts.split()
      points2D = np.asarray(
          [[float(x), float(y)]
           for x, y in zip(tokens[0::3], tokens[1::3])])
      point3D_ids = np.asarray([int(i) for i in tokens[2::3]], np.int64)
      self.images[image_id] = Image(
          image_id, name, camera_id, qvec, tvec, points2D, point3D_ids)

  def load_points3D(self):
    bin_path = self._path('points3D.bin')
    if bin_path.exists():
      self._load_points3D_bin(bin_path)
    else:
      self._load_points3D_txt(self._path('points3D.txt'))
    self.point3D_id_to_point3D_idx = {
        int(pid): i for i, pid in enumerate(self.point3D_ids)}

  def _load_points3D_bin(self, path):
    xyz, ids, colors, errors, tracks = [], [], [], [], []
    with open(path, 'rb') as f:
      (num_points,) = _read(f, '<Q')
      for _ in range(num_points):
        (point_id,) = _read(f, '<Q')
        p_xyz = _read(f, '<3d')
        rgb = _read(f, '<3B')
        (error,) = _read(f, '<d')
        (track_len,) = _read(f, '<Q')
        track = np.frombuffer(
            f.read(8 * track_len),
            dtype=np.dtype([('image_id', '<i4'), ('p2d', '<i4')]))
        ids.append(point_id)
        xyz.append(p_xyz)
        colors.append(rgb)
        errors.append(error)
        tracks.append([(int(t['image_id']), int(t['p2d'])) for t in track])
    self._set_points(ids, xyz, colors, errors, tracks)

  def _load_points3D_txt(self, path):
    xyz, ids, colors, errors, tracks = [], [], [], [], []
    with open(path, 'r') as f:
      for line in f:
        line = line.strip()
        if not line or line.startswith('#'):
          continue
        parts = line.split()
        ids.append(int(parts[0]))
        xyz.append([float(v) for v in parts[1:4]])
        colors.append([int(v) for v in parts[4:7]])
        errors.append(float(parts[7]))
        track_tokens = parts[8:]
        tracks.append([(int(i), int(j)) for i, j in
                       zip(track_tokens[0::2], track_tokens[1::2])])
    self._set_points(ids, xyz, colors, errors, tracks)

  def _set_points(self, ids, xyz, colors, errors, tracks):
    self.point3D_ids = np.asarray(ids, np.uint64)
    self.points3D = np.asarray(xyz, np.float64).reshape(-1, 3)
    self.point3D_colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    self.point3D_errors = np.asarray(errors, np.float64)
    self.point3D_tracks = tracks
    self.point3D_id_to_point3D_idx = {
        int(pid): i for i, pid in enumerate(self.point3D_ids)}

  # --- saving ---

  def save(self, output_dir, binary: bool = True):
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if binary:
      self._save_cameras_bin(output_dir / 'cameras.bin')
      self._save_images_bin(output_dir / 'images.bin')
      self._save_points3D_bin(output_dir / 'points3D.bin')
    else:
      self._save_cameras_txt(output_dir / 'cameras.txt')
      self._save_images_txt(output_dir / 'images.txt')
      self._save_points3D_txt(output_dir / 'points3D.txt')

  def _save_cameras_bin(self, path):
    with open(path, 'wb') as f:
      f.write(struct.pack('<Q', len(self.cameras)))
      for camera_id in sorted(self.cameras):
        cam = self.cameras[camera_id]
        f.write(struct.pack('<iiQQ', cam.camera_id, cam.model_id,
                            cam.width, cam.height))
        f.write(struct.pack(f'<{len(cam.params)}d', *cam.params))

  def _save_cameras_txt(self, path):
    with open(path, 'w') as f:
      f.write('# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n')
      for camera_id in sorted(self.cameras):
        cam = self.cameras[camera_id]
        params = ' '.join(repr(float(p)) for p in cam.params)
        f.write(f'{cam.camera_id} {cam.model_name} {cam.width} '
                f'{cam.height} {params}\n')

  def _save_images_bin(self, path):
    with open(path, 'wb') as f:
      f.write(struct.pack('<Q', len(self.images)))
      for image_id in sorted(self.images):
        im = self.images[image_id]
        f.write(struct.pack('<i', im.image_id))
        f.write(struct.pack('<4d', *im.qvec))
        f.write(struct.pack('<3d', *im.tvec))
        f.write(struct.pack('<i', im.camera_id))
        f.write(im.name.encode('utf-8') + b'\x00')
        f.write(struct.pack('<Q', len(im.points2D)))
        for (x, y), pid in zip(im.points2D, im.point3D_ids):
          f.write(struct.pack('<ddq', x, y, int(pid)))

  def _save_images_txt(self, path):
    with open(path, 'w') as f:
      f.write('# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n')
      for image_id in sorted(self.images):
        im = self.images[image_id]
        q = ' '.join(repr(float(v)) for v in im.qvec)
        t = ' '.join(repr(float(v)) for v in im.tvec)
        f.write(f'{im.image_id} {q} {t} {im.camera_id} {im.name}\n')
        pts = ' '.join(
            f'{repr(float(x))} {repr(float(y))} {int(pid)}'
            for (x, y), pid in zip(im.points2D, im.point3D_ids))
        f.write(pts + '\n')

  def _save_points3D_bin(self, path):
    with open(path, 'wb') as f:
      f.write(struct.pack('<Q', len(self.point3D_ids)))
      for i, pid in enumerate(self.point3D_ids):
        f.write(struct.pack('<Q', int(pid)))
        f.write(struct.pack('<3d', *self.points3D[i]))
        f.write(struct.pack('<3B', *self.point3D_colors[i]))
        f.write(struct.pack('<d', self.point3D_errors[i]))
        track = self.point3D_tracks[i]
        f.write(struct.pack('<Q', len(track)))
        for image_id, p2d_idx in track:
          f.write(struct.pack('<ii', image_id, p2d_idx))

  def _save_points3D_txt(self, path):
    with open(path, 'w') as f:
      f.write('# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n')
      for i, pid in enumerate(self.point3D_ids):
        xyz = ' '.join(repr(float(v)) for v in self.points3D[i])
        rgb = ' '.join(str(int(v)) for v in self.point3D_colors[i])
        track = ' '.join(f'{img} {p2d}'
                         for img, p2d in self.point3D_tracks[i])
        f.write(f'{int(pid)} {xyz} {rgb} '
                f'{repr(float(self.point3D_errors[i]))} {track}\n')

  # --- queries / filtering ---

  def get_camera(self, camera_id: int) -> ColmapCamera:
    return self.cameras[camera_id]

  def get_image_from_name(self, name: str) -> Image:
    return self.images[self.name_to_image_id[name]]

  def get_filtered_points3D(self, min_track_len: int = 0,
                            max_error: float = np.inf,
                            return_colors: bool = False):
    """Points filtered by track length and reprojection error."""
    keep = np.asarray([
        len(track) >= min_track_len and err <= max_error
        for track, err in zip(self.point3D_tracks, self.point3D_errors)
    ], bool)
    if keep.size == 0:
      keep = np.zeros((0,), bool)
    if return_colors:
      return self.points3D[keep], self.point3D_colors[keep]
    return self.points3D[keep]

  def filter_points3D(self, min_track_len: int = 0,
                      max_error: float = np.inf):
    """In-place filtering; keeps id mappings consistent."""
    keep = np.asarray([
        len(track) >= min_track_len and err <= max_error
        for track, err in zip(self.point3D_tracks, self.point3D_errors)
    ], bool)
    if keep.size == 0:
      return self
    self.points3D = self.points3D[keep]
    self.point3D_ids = self.point3D_ids[keep]
    self.point3D_colors = self.point3D_colors[keep]
    self.point3D_errors = self.point3D_errors[keep]
    self.point3D_tracks = [
        t for t, k in zip(self.point3D_tracks, keep) if k]
    self.point3D_id_to_point3D_idx = {
        int(pid): i for i, pid in enumerate(self.point3D_ids)}
    return self

  # --- scene queries (parity: pycolmap scene_manager.py:450-560) ---

  def point3D_valid(self, point3D_id) -> bool:
    """Whether the id maps to a (non-filtered) reconstructed point."""
    return int(point3D_id) in self.point3D_id_to_point3D_idx

  def get_points3D(self, image_id, return_points2D: bool = False,
                   return_colors: bool = False):
    """3D points observed by one image (optionally + 2D pixels, colors)."""
    image = self.images[image_id]
    idxs, point2D_idxs = [], []
    for i, pid in enumerate(image.point3D_ids):
      if pid >= 0 and self.point3D_valid(pid):
        idxs.append(self.point3D_id_to_point3D_idx[int(pid)])
        point2D_idxs.append(i)
    idxs = np.asarray(idxs, int)
    result = [self.points3D[idxs]]
    if return_points2D:
      result.append(image.points2D[np.asarray(point2D_idxs, int)])
    if return_colors:
      result.append(self.point3D_colors[idxs])
    return result[0] if len(result) == 1 else tuple(result)

  def get_shared_points3D(self, image_id1, image_id2) -> np.ndarray:
    """3D points observed by BOTH images (covisible landmarks)."""
    ids1 = {int(p) for p in self.images[image_id1].point3D_ids if p >= 0}
    ids2 = {int(p) for p in self.images[image_id2].point3D_ids if p >= 0}
    shared = [self.point3D_id_to_point3D_idx[p] for p in ids1 & ids2
              if self.point3D_valid(p)]
    return self.points3D[np.asarray(shared, int)]

  def get_viewed_points(self, image_id) -> np.ndarray:
    """All reconstructed points in front of the image's camera,
    expressed in that camera's frame."""
    image = self.images[image_id]
    points_cam = self.points3D @ image.R().T + image.tvec[None, :]
    return points_cam[points_cam[:, 2] > 0]

  def delete_images(self, image_ids) -> 'SceneManager':
    """Removes images and scrubs them from every point track."""
    doomed = {int(i) for i in image_ids}
    for image_id in doomed:
      self.images.pop(image_id, None)
    self.name_to_image_id = {
        name: iid for name, iid in self.name_to_image_id.items()
        if iid not in doomed}
    self.point3D_tracks = [
        [(iid, p2d) for iid, p2d in track if iid not in doomed]
        for track in self.point3D_tracks]
    return self

  def build_scene_graph(self):
    """Covisibility graph: scene_graph[i][j] = #points seen by both i, j."""
    from collections import defaultdict
    from itertools import combinations
    self.scene_graph = defaultdict(lambda: defaultdict(int))
    for track in self.point3D_tracks:
      track_images = sorted({iid for iid, _ in track})
      for a, b in combinations(track_images, 2):
        self.scene_graph[a][b] += 1
        self.scene_graph[b][a] += 1
    return self.scene_graph

  def load_colmap_project_file(self, project_file=None, image_path=None):
    """Reads image_path from a COLMAP project.ini when not given."""
    self.image_path = image_path
    if self.image_path is None:
      if project_file is None:
        project_file = self.colmap_dir / 'project.ini'
      with open(project_file, 'r') as f:
        for line in f:
          if line.startswith('image_path'):
            self.image_path = line.split('=', 1)[1].strip()
            break
    return self.image_path
