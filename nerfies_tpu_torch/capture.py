"""Capture processing: COLMAP reconstruction -> nerfies dataset directory.

Port of nerfies_tpu/capture.py (the library form of the upstream Nerfies
capture-processing notebook): camera conversion, blur filtering, near/far
estimation from the point cloud, scene center/scale from the bounding
box, orbit-path generation, the dataset/scene/metadata JSON writers and
the face-landmark normalization. Numpy only, with the port's `Camera`,
`image_utils` and `colmap`; no cv2: the blur score's grey conversion and
Laplacian are cv2's integer arithmetic in numpy, so the scores, the kept
frames and every file written equal the JAX package's.
"""

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch.camera import Camera
from nerfies_tpu_torch.colmap import SceneManager


def convert_colmap_camera(colmap_camera, colmap_image) -> Camera:
  """COLMAP camera+pose -> a nerfies Camera (world-to-camera orientation)."""
  rotation = colmap_image.R()
  position = colmap_image.C()
  fx, fy = colmap_camera.focal
  cx, cy = colmap_camera.principal_point
  k1, k2, p1, p2, k3 = colmap_camera.distortion
  return Camera(
      orientation=rotation,
      position=position,
      focal_length=fx,
      pixel_aspect_ratio=fy / fx,
      principal_point=np.array([cx, cy]),
      radial_distortion=np.array([k1, k2, k3]),
      tangential_distortion=np.array([p1, p2]),
      skew=0.0,
      image_size=np.array([colmap_camera.width, colmap_camera.height]),
  )


def load_colmap_cameras(scene: SceneManager) -> Dict[str, Camera]:
  """All registered images as nerfies Cameras, keyed by image stem."""
  cameras = {}
  for image in scene.images.values():
    colmap_camera = scene.get_camera(image.camera_id)
    name = Path(image.name).stem
    cameras[name] = convert_colmap_camera(colmap_camera, image)
  return cameras


def filter_outlier_points(points: np.ndarray,
                          inner_percentile: float) -> np.ndarray:
  """Keeps points inside the axis-aligned inner-percentile box."""
  outer = 1.0 - inner_percentile
  lower = outer / 2.0
  upper = 1.0 - lower
  centers_min = np.quantile(points, lower, axis=0)
  centers_max = np.quantile(points, upper, axis=0)
  too_near = np.any(points < centers_min[None, :], axis=1)
  too_far = np.any(points > centers_max[None, :], axis=1)
  return points[~(too_near | too_far)]


# cv2's COLOR_RGB2GRAY for uint8: 0.299 R + 0.587 G + 0.114 B in 15-bit
# fixed point, rounded (equal to cv2 on all 2^24 colours).
_GRAY_WEIGHTS = (9798, 19235, 3735)
_GRAY_SHIFT = 15


def rgb_to_gray(image: np.ndarray) -> np.ndarray:
  """(H, W, 3) uint8 RGB -> (H, W) uint8, as cv2.cvtColor(RGB2GRAY)."""
  x = image.astype(np.int32)  # 255 * 2^15 + 2^14 < 2^31
  r, g, b = _GRAY_WEIGHTS
  gray = (x[..., 0] * r + x[..., 1] * g + x[..., 2] * b
          + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
  return gray.astype(np.uint8)


def compute_blur_scores(images: Sequence[np.ndarray]) -> np.ndarray:
  """Variance-of-Laplacian focus measure per image (higher = sharper)."""
  scores = []
  for image in images:
    gray = rgb_to_gray(image_utils.image_to_uint8(image))
    scores.append(image_utils.variance_of_laplacian(gray))
  return np.asarray(scores)


def select_sharp_frames(blur_scores: np.ndarray,
                        keep_percentile: float = 95.0) -> np.ndarray:
  """Indices of frames at or above the blur-score percentile threshold."""
  threshold = np.percentile(blur_scores, 100.0 - keep_percentile)
  return np.where(blur_scores >= threshold)[0]


def estimate_near_far_for_camera(camera: Camera, points: np.ndarray,
                                 camera_positions: np.ndarray
                                 ) -> Tuple[float, float]:
  """Depth quantiles of in-frustum scene points for one camera."""
  candidates = np.concatenate([points, camera_positions], axis=0)
  pixels = camera.project(candidates)
  depths = camera.points_to_local_points(candidates)[..., 2]
  in_frustum = ((pixels[..., 0] >= 0.0)
                & (pixels[..., 0] <= camera.image_size_x)
                & (pixels[..., 1] >= 0.0)
                & (pixels[..., 1] <= camera.image_size_y)
                & (depths > 0))
  depths = depths[in_frustum]
  if depths.size == 0:
    raise ValueError('No scene points visible from camera.')
  return float(np.quantile(depths, 0.001)), float(np.quantile(depths, 0.999))


def estimate_near_far(cameras: Sequence[Camera], points: np.ndarray,
                      inner_percentile: float = 0.95
                      ) -> Tuple[float, float]:
  """Aggregate near/far planes with the notebook's x0.8 / x1.2 margins."""
  points = filter_outlier_points(points, inner_percentile)
  positions = np.stack([c.position for c in cameras])
  nears, fars = [], []
  for camera in cameras:
    near, far = estimate_near_far_for_camera(camera, points, positions)
    nears.append(near)
    fars.append(far)
  near = float(np.quantile(np.asarray(nears), 0.001) / 0.8)
  far = float(np.quantile(np.asarray(fars), 0.999) * 1.2)
  return near, far


def compute_scene_center_scale(points: np.ndarray,
                               camera_positions: np.ndarray,
                               inner_percentile: float = 0.95
                               ) -> Tuple[np.ndarray, float, np.ndarray]:
  """Scene center (bbox mean) + scale (1 / bbox diagonal)."""
  points = filter_outlier_points(points, inner_percentile)
  combined = np.concatenate([points, camera_positions], axis=0)
  lower = combined.min(axis=0)
  upper = combined.max(axis=0)
  bbox = np.stack([lower, upper])
  center = bbox.mean(axis=0)
  scale = 1.0 / float(np.sqrt(np.sum((upper - lower) ** 2)))
  return center, scale, bbox


def triangulate_rays(origins: np.ndarray,
                     directions: np.ndarray) -> np.ndarray:
  """Least-squares point closest to a bundle of rays.

  Solves sum_i || (I - d_i d_i^T)(x - o_i) ||^2 -> normal equations.
  """
  directions = directions / np.linalg.norm(directions, axis=-1,
                                           keepdims=True)
  eye = np.eye(3)
  A = np.zeros((3, 3))
  b = np.zeros(3)
  for o, d in zip(origins, directions):
    P = eye - np.outer(d, d)
    A += P
    b += P @ o
  return np.linalg.solve(A, b)


def generate_orbit_cameras(ref_cameras: Sequence[Camera],
                           num_frames: int = 100,
                           radius_scale: float = 0.75,
                           z_offset: float = -0.1) -> List[Camera]:
  """An orbit of novel-view cameras around the capture's mean position.

  Matches the notebook's orbit recipe (cell 32): orbit around the average
  camera position at a radius proportional to the camera-spread bounding
  size, all aimed at the triangulated mutual look-at point.
  """
  origins = np.array([c.position for c in ref_cameras])
  axes = np.array([c.optical_axis for c in ref_cameras])
  look_at = triangulate_rays(origins, axes)
  avg_position = origins.mean(axis=0)
  up = -np.mean([c.orientation[1] for c in ref_cameras], axis=0)

  bounds = origins.max(axis=0) - origins.min(axis=0)
  bounding_size = np.linalg.norm(bounds) / 2.0
  r = radius_scale * radius_scale * bounding_size  # x/y scale * radius

  ref_camera = ref_cameras[0]
  cameras = []
  for angle in np.linspace(0, 2 * np.pi, num=num_frames):
    offset = np.array([np.cos(angle) * r, np.sin(angle) * r, z_offset])
    cameras.append(ref_camera.look_at(avg_position + offset, look_at, up))
  return cameras


def write_dataset_json(data_dir, train_ids: Sequence[str],
                       val_ids: Sequence[str]) -> None:
  all_ids = list(train_ids) + list(val_ids)
  with open(Path(data_dir) / 'dataset.json', 'w') as f:
    json.dump({
        'count': len(all_ids),
        'num_exemplars': len(train_ids),
        'ids': all_ids,
        'train_ids': list(train_ids),
        'val_ids': list(val_ids),
    }, f, indent=2)


def write_scene_json(data_dir, center, scale, near, far, bbox=None) -> None:
  scene = {
      'scale': float(scale),
      'center': np.asarray(center).tolist(),
      'near': float(near * scale),
      'far': float(far * scale),
  }
  if bbox is not None:
    scene['bbox'] = np.asarray(bbox).tolist()
  with open(Path(data_dir) / 'scene.json', 'w') as f:
    json.dump(scene, f, indent=2)


def write_metadata_json(data_dir, item_ids: Sequence[str],
                        camera_ids: Optional[Sequence[int]] = None) -> None:
  """Per-frame metadata: by default one warp/appearance/time id per frame."""
  metadata = {}
  for i, item_id in enumerate(item_ids):
    metadata[item_id] = {
        'warp_id': i,
        'appearance_id': i,
        'camera_id': int(camera_ids[i]) if camera_ids is not None else 0,
        'time_id': i,
    }
  with open(Path(data_dir) / 'metadata.json', 'w') as f:
    json.dump(metadata, f, indent=2)


def write_image_pyramid(data_dir, item_id: str, image: np.ndarray,
                        scales: Sequence[int] = (1, 2, 4, 8)) -> None:
  """Writes rgb/{s}x/{item_id}.png for each pyramid level."""
  image = image_utils.image_to_float32(image)
  image = image_utils.make_divisible(image, max(scales))
  for scale in scales:
    out_dir = Path(data_dir) / 'rgb' / f'{scale}x'
    out_dir.mkdir(parents=True, exist_ok=True)
    scaled = (image if scale == 1
              else image_utils.downsample_image(image, scale))
    image_utils.save_image(out_dir / f'{item_id}.png',
                           image_utils.image_to_uint8(scaled))


def process_capture(colmap_dir,
                    images: Dict[str, np.ndarray],
                    output_dir,
                    val_fraction: float = 0.2,
                    blur_keep_percentile: float = 100.0,
                    image_scales: Sequence[int] = (1, 2, 4, 8),
                    min_track_len: int = 2,
                    orbit_frames: int = 60,
                    face_landmarks: Optional[Dict[str, np.ndarray]] = None,
                    reference_ipd: float = 0.06) -> Path:
  """Full pipeline: COLMAP sparse model + images -> nerfies dataset dir.

  Args:
    colmap_dir: COLMAP sparse reconstruction directory.
    images: {item_id: float/uint8 RGB image} keyed like the COLMAP image
      stems.
    output_dir: dataset output directory.
    val_fraction: fraction of frames held out for validation.
    blur_keep_percentile: keep this percentile of sharpest frames
      (100 = keep all).
    image_scales: rgb pyramid levels to write.
    min_track_len: COLMAP track-length filter for background points.
    orbit_frames: frames in the generated orbit camera paths.
    face_landmarks: optional {item_id: (L, 2) pixel landmarks} (see
      `compute_face_landmarks`); when given, the scene is re-oriented
      into the face-canonical basis and rescaled to meters via the
      inter-pupillary distance (notebook cells 23-25).
    reference_ipd: the assumed IPD in meters for metric scaling.

  Returns:
    The dataset directory.
  """
  output_dir = Path(output_dir)
  (output_dir / 'camera').mkdir(parents=True, exist_ok=True)

  scene = SceneManager(colmap_dir).load()
  cameras = load_colmap_cameras(scene)
  item_ids = sorted(set(cameras) & set(images))

  if blur_keep_percentile < 100.0:
    scores = compute_blur_scores([images[i] for i in item_ids])
    keep = select_sharp_frames(scores, blur_keep_percentile)
    item_ids = [item_ids[i] for i in sorted(keep)]

  points = scene.get_filtered_points3D(min_track_len=min_track_len)

  if face_landmarks:
    lm_ids = sorted(set(face_landmarks) & set(item_ids))
    if len(lm_ids) < 2:
      raise ValueError('Face normalization needs landmarks for >= 2 '
                       f'registered frames, got {len(lm_ids)}.')
    basis, origin, metric_scale = landmark_scene_normalization(
        [face_landmarks[i] for i in lm_ids],
        [cameras[i] for i in lm_ids],
        reference_ipd=reference_ipd)
    cameras = {i: transform_camera(c, basis, origin, metric_scale)
               for i, c in cameras.items()}
    points = transform_points(points, basis, origin, metric_scale)

  camera_list = [cameras[i] for i in item_ids]
  near, far = estimate_near_far(camera_list, points)
  positions = np.stack([c.position for c in camera_list])
  center, scale, bbox = compute_scene_center_scale(points, positions)

  # Save cameras and image pyramids.
  for item_id in item_ids:
    cameras[item_id].save_json(output_dir / 'camera' / f'{item_id}.json')
    write_image_pyramid(output_dir, item_id, images[item_id],
                        scales=image_scales)

  # Background points in WORLD coordinates (the datasource re-centers).
  with open(output_dir / 'points.npy', 'wb') as f:
    np.save(f, points.astype(np.float32))

  # Train/val split: every k-th frame is validation.
  num_val = max(1, int(len(item_ids) * val_fraction))
  val_stride = max(1, len(item_ids) // num_val)
  val_ids = item_ids[val_stride - 1::val_stride][:num_val]
  train_ids = [i for i in item_ids if i not in set(val_ids)]
  write_dataset_json(output_dir, train_ids, val_ids)
  write_scene_json(output_dir, center, scale, near, far, bbox)
  write_metadata_json(output_dir, item_ids)

  # Orbit camera paths for novel-view rendering.
  for name, z_offset in (('orbit-mild', -0.1), ('orbit-extreme', -0.3)):
    path_dir = output_dir / 'camera-paths' / name
    path_dir.mkdir(parents=True, exist_ok=True)
    for j, cam in enumerate(generate_orbit_cameras(
        camera_list, num_frames=orbit_frames, z_offset=z_offset)):
      cam.save_json(path_dir / f'{j:06d}.json')

  return output_dir


# ---------------------------------------------------------------------------
# Face-landmark metric normalization (upstream notebook cells 23-25).
#
# The upstream notebook detects a MediaPipe face mesh in each frame, triangulates
# the landmarks in 3D, and uses the face to (a) re-orient the scene into a
# canonical face-aligned frame and (b) recover metric scale from the
# inter-pupillary distance. The geometry lives here; landmark *detection*
# is pluggable (`compute_face_landmarks` uses mediapipe when installed).
# ---------------------------------------------------------------------------

# Canonical MediaPipe face-mesh vertex indices (public topology).
NOSE_TIP_IDX = 1
FOREHEAD_IDX = 10
CHIN_IDX = 152
RIGHT_EYE_IDX = 145
LEFT_EYE_IDX = 385
RIGHT_TEMPLE_IDX = 162
LEFT_TEMPLE_IDX = 389

# Mean adult inter-pupillary distance, meters.
DEFAULT_IPD = 0.06


def compute_face_landmarks(image: np.ndarray) -> Optional[np.ndarray]:
  """2D face-mesh landmarks in pixels, or None if no face is found.

  Requires the optional `mediapipe` package (notebook cell 23); raises
  ImportError with guidance when it is missing.
  """
  try:
    import mediapipe as mp  # deferred: optional capture-only dependency
  except ImportError as e:
    raise ImportError(
        'Face landmarks need the optional `mediapipe` package, which is '
        'not installed; run without --use_face.') from e
  height, width = image.shape[:2]
  with mp.solutions.face_mesh.FaceMesh(
      static_image_mode=True, max_num_faces=2,
      min_detection_confidence=0.5) as face_mesh:
    results = face_mesh.process(image_utils.image_to_uint8(image))
  if results.multi_face_landmarks is None:
    return None
  landmarks = results.multi_face_landmarks[0].landmark
  return np.array([(o.x * width, o.y * height) for o in landmarks],
                  np.float32)


def triangulate_landmarks(landmarks_px: Sequence[np.ndarray],
                          cameras: Sequence[Camera]) -> np.ndarray:
  """3D positions of per-image 2D landmarks, one ray bundle per landmark.

  Args:
    landmarks_px: per-camera (L, 2) pixel arrays (same landmark order).
    cameras: the matching cameras.

  Returns:
    (L, 3) triangulated landmark positions.
  """
  origins = np.stack([np.broadcast_to(c.position, (len(px), 3))
                      for c, px in zip(cameras, landmarks_px)])
  directions = np.stack([
      np.asarray(c.pixels_to_rays(px.astype(np.float32)))
      for c, px in zip(cameras, landmarks_px)])
  num_landmarks = origins.shape[1]
  return np.stack([
      triangulate_rays(origins[:, i], directions[:, i])
      for i in range(num_landmarks)
  ]).astype(np.float32)


def fit_plane_normal(points: np.ndarray) -> np.ndarray:
  """Unit normal of the least-squares plane through `points`."""
  centered = points - points.mean(axis=0)
  _, _, vh = np.linalg.svd(centered, full_matrices=False)
  normal = vh[2]
  return normal / np.linalg.norm(normal)


def basis_from_landmarks(landmark_points: np.ndarray) -> np.ndarray:
  """Orthonormal face basis (columns = x, y, z axes in world coords).

  Z comes from the fitted face-plane normal (robust for full-body
  captures), Y from chin->forehead, X from temple->temple; the normal's
  sign is fixed by the right-handedness heuristic, then Y and X are
  re-orthogonalized around the fixed Z.
  """
  def normalize(v):
    return v / np.linalg.norm(v)

  axis_z = normalize(fit_plane_normal(landmark_points))
  axis_y = normalize(landmark_points[FOREHEAD_IDX]
                     - landmark_points[CHIN_IDX])
  axis_x = normalize(landmark_points[LEFT_TEMPLE_IDX]
                     - landmark_points[RIGHT_TEMPLE_IDX])
  if np.dot(np.cross(axis_x, axis_y), axis_z) < 0.0:
    axis_z = -axis_z
  # Re-orthogonalize around the fixed Z, renormalizing after each cross
  # (the reference notebook skips the renormalization, leaving its basis
  # slightly non-orthonormal when the raw axes aren't perpendicular).
  axis_y = normalize(np.cross(axis_z, axis_x))
  axis_x = normalize(np.cross(axis_y, axis_z))
  return np.stack([axis_x, axis_y, axis_z]).T


def metric_scale_from_ipd(landmark_points: np.ndarray,
                          reference_ipd: float = DEFAULT_IPD) -> float:
  """Scene-units -> meters ratio from the triangulated eye landmarks."""
  model_ipd = np.linalg.norm(landmark_points[LEFT_EYE_IDX]
                             - landmark_points[RIGHT_EYE_IDX])
  return float(reference_ipd / model_ipd)


def transform_camera(camera: Camera, basis: np.ndarray,
                     origin: np.ndarray, scale: float = 1.0) -> Camera:
  """Re-expresses a camera in the frame (basis columns, origin), scaled.

  World point x maps to x' = scale * basis^T (x - origin). With
  world-to-camera orientation R and position p, the transformed camera has
  orientation R' = R basis and position p' = scale * basis^T (p - origin)
  (so R'(x' - p') = scale * R (x - p): same rays, rescaled depths).
  """
  new_camera = camera.copy()
  new_camera.orientation = camera.orientation @ basis
  new_camera.position = (scale * (basis.T @ (camera.position - origin))
                         ).astype(camera.position.dtype)
  return new_camera


def transform_points(points: np.ndarray, basis: np.ndarray,
                     origin: np.ndarray, scale: float = 1.0) -> np.ndarray:
  """Applies the same frame change to world points."""
  return scale * (points - origin) @ basis


def landmark_scene_normalization(
    landmarks_px: Sequence[np.ndarray],
    cameras: Sequence[Camera],
    reference_ipd: float = DEFAULT_IPD,
) -> Tuple[np.ndarray, np.ndarray, float]:
  """Face-canonical frame for the whole scene (notebook cell 25).

  Returns:
    (basis, origin, scale): pass to `transform_camera` /
    `transform_points`. `origin` is the nose tip, `basis` the face axes,
    `scale` the metric (meters) conversion from the inter-pupillary
    distance.
  """
  landmark_points = triangulate_landmarks(landmarks_px, cameras)
  basis = basis_from_landmarks(landmark_points)
  origin = landmark_points[NOSE_TIP_IDX]
  scale = metric_scale_from_ipd(landmark_points, reference_ipd)
  return basis, origin, scale
