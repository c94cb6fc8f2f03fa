"""Synthetic nerfies-format scene generator (testing and demos).

Port of nerfies_tpu/datasets/synthetic.py: the same scene, cameras, ids
and points. Writes a complete capture directory in the nerfies on-disk
format: a sphere at the origin rendered analytically from orbiting
cameras, with an optional per-frame translation so the deformation field
has signal to learn (dataset.json / scene.json / metadata.json /
rgb/{s}x / camera / camera-paths / points.npy), without COLMAP.
"""

import json
from pathlib import Path
from typing import Optional

import numpy as np

from nerfies_tpu_torch import camera as cam
from nerfies_tpu_torch import image_utils


ENV_RADIUS = 4.0


def _env_color(directions: np.ndarray) -> np.ndarray:
  """Procedural environment-sphere texture for unit hit points (..., 3).

  Mid-range ([~0.1, 0.9]) multi-band colors: no pixel sits at an exact
  0/1 sigmoid asymptote, so the trivial constant fit scores badly and
  head logits have a finite-logit optimum (see the saturation-collapse
  note in write_synthetic_dataset).
  """
  u = directions
  r = 0.5 + 0.25 * np.sin(3.1 * u[..., 0] + 1.7 * u[..., 2]) \
      + 0.15 * np.sin(7.3 * u[..., 1])
  g = 0.5 + 0.25 * np.sin(2.3 * u[..., 1] - 1.1 * u[..., 0]) \
      + 0.15 * np.sin(6.1 * u[..., 2] + 0.9)
  b = 0.5 + 0.25 * np.sin(2.9 * u[..., 2] + 2.1 * u[..., 1]) \
      + 0.15 * np.sin(5.7 * u[..., 0] + 2.0)
  return np.clip(np.stack([r, g, b], axis=-1), 0.05, 0.95)


def render_sphere_image(camera: cam.Camera,
                        sphere_center=(0.0, 0.0, 0.0),
                        sphere_radius: float = 0.5,
                        background: float = 1.0,
                        texture_frequency: float = 0.0,
                        env_background: bool = False,
                        return_depth: bool = False) -> np.ndarray:
  """Analytically renders a normal-shaded sphere seen by `camera`.

  `texture_frequency > 0` modulates the shading with a smooth
  multi-band procedural pattern tied to the surface normal (it deforms
  rigidly with the sphere), giving the quality benchmark high-frequency
  detail to actually resolve; 0 keeps the plain normal-shaded sphere.

  `env_background=True` replaces the constant background with a static
  textured environment sphere (radius ENV_RADIUS, origin-centered) so
  every ray terminates on learnable geometry with mid-range colors —
  the capture-like regime. A constant background of exactly 1.0 makes
  the scene 90% pure white, whose fastest-descent fit drives the rgb
  sigmoid into exact f32 saturation and kills every NeRF-MLP gradient
  bitwise (the JAX package's docs/PERFORMANCE.md).

  With `return_depth`, also returns the ray-distance depth map (0 where
  the ray misses all geometry, matching eval's valid-depth convention).
  """
  rays = camera.pixels_to_rays(camera.get_pixel_centers())
  origins = np.broadcast_to(camera.position, rays.shape)
  center = np.asarray(sphere_center, np.float32)

  oc = origins - center
  b = np.sum(oc * rays, axis=-1)
  c = np.sum(oc * oc, axis=-1) - sphere_radius ** 2
  disc = b * b - c
  hit = disc > 0
  t = -b - np.sqrt(np.maximum(disc, 0.0))
  hit &= t > 0

  points = origins + t[..., None] * rays
  normals = (points - center) / sphere_radius
  color = 0.5 * (normals + 1.0)
  if texture_frequency > 0.0:
    k = texture_frequency
    pattern = (np.sin(k * normals[..., 0]) * np.sin(k * normals[..., 1])
               + np.sin(k * normals[..., 2])
               + 0.5 * np.sin(2.3 * k * normals[..., 0])
               * np.sin(1.7 * k * normals[..., 2]))
    color = color * (0.65 + 0.35 * np.tanh(pattern))[..., None]
  if env_background:
    # Env sphere |o + t d| = R, camera inside: take the positive root.
    be = np.sum(origins * rays, axis=-1)
    ce = np.sum(origins * origins, axis=-1) - ENV_RADIUS ** 2
    t_env = -be + np.sqrt(np.maximum(be * be - ce, 0.0))
    env_pts = (origins + t_env[..., None] * rays) / ENV_RADIUS
    image = _env_color(env_pts)
    depth_bg = t_env
  else:
    image = np.full(rays.shape, background, np.float32)
    depth_bg = np.zeros_like(t)
  image = image.copy()
  image[hit] = color[hit]
  image = np.clip(image, 0.0, 1.0)
  if return_depth:
    return image, np.where(hit, t, depth_bg).astype(np.float32)
  return image


def make_orbit_camera(theta: float, image_size=(64, 48), radius: float = 3.0,
                      focal: Optional[float] = None) -> cam.Camera:
  # Focal scales with image width to keep the field of view (and so the
  # subject's footprint in the frame) resolution-independent. A fixed
  # 60 px focal made 384-wide renders a ~145-degree fisheye in which the
  # unit sphere covered 0.27% of pixels -- an all-white "fit" then scored
  # a high PSNR without learning any geometry.
  if focal is None:
    focal = 60.0 / 64.0 * float(image_size[0])
  position = np.asarray(
      [radius * np.cos(theta), 0.4, radius * np.sin(theta)], np.float32)
  base = cam.Camera(
      orientation=np.eye(3),
      position=position,
      focal_length=focal,
      principal_point=np.asarray(image_size, np.float32) / 2.0,
      image_size=np.asarray(image_size, np.uint32),
  )
  return base.look_at(position, np.zeros(3), np.asarray([0.0, 1.0, 0.0]))


def write_synthetic_dataset(data_dir,
                            num_train: int = 8,
                            num_val: int = 2,
                            image_size=(64, 48),
                            image_scales=(1,),
                            motion_amplitude: float = 0.0,
                            texture_frequency: float = 0.0,
                            env_background: bool = False,
                            num_points: int = 256,
                            write_depth: bool = False,
                            cameras_per_state: int = 1,
                            seed: int = 0) -> Path:
  """Writes a full nerfies-format capture directory.

  Args:
    data_dir: output directory.
    num_train / num_val: frame counts.
    image_size: (width, height) at scale 1.
    image_scales: which rgb/{s}x pyramids to write.
    motion_amplitude: per-frame sphere translation amplitude (gives the
      warp field something to learn; 0 = static scene).
    texture_frequency: procedural surface-texture frequency (see
      `render_sphere_image`); 0 = plain shading.
    env_background: render a static textured environment sphere instead
      of the constant white background (see `render_sphere_image`; the
      scene's far plane extends to cover it). Use for quality/convergence
      benchmarks — a 90%-pure-white target collapses training into exact
      rgb-sigmoid saturation.
    num_points: background points written to points.npy.
    cameras_per_state: training cameras observing each deformation state
      (consecutive orbit cameras share one state/metadata id). 1 = the
      monocular-video regime, where every state is seen from exactly one
      viewpoint and the warp field can explain each frame independently
      of 3D-consistent geometry — novel-view PSNR then saturates ~20 dB
      below train-view PSNR (this shape-warp ambiguity is why Nerfies
      evaluates on validation-rig captures, the "vrig" configs). 2 = the
      vrig regime:
      every state is multi-view constrained and novel-view quality
      tracks the fit.
    seed: rng seed for the background points.

  Returns:
    The dataset directory path.
  """
  data_dir = Path(data_dir)
  (data_dir / 'camera').mkdir(parents=True, exist_ok=True)
  num_frames = num_train + num_val
  if num_train % cameras_per_state:
    raise ValueError(f'num_train={num_train} not divisible by '
                     f'cameras_per_state={cameras_per_state}')
  num_states = num_train // cameras_per_state

  all_ids = [f'{i:04d}' for i in range(num_frames)]
  thetas = list(np.linspace(0.0, 2.0 * np.pi, num_frames, endpoint=False))
  # Validation frames reuse a train state's metadata ids (vrig-style: the
  # val camera shares each time instant with train cameras), so their
  # ground truth must show the scene in THAT state's deformation —
  # rendering val GT at its own orbit phase while the model renders with
  # the reused (trained) warp code misplaces the sphere by up to
  # motion_amplitude and caps val PSNR at ~23.5 dB no matter how well the
  # fit converges. Val states spread evenly
  # over the train states, and each val camera sits between (offset half
  # a camera spacing from) its state's train cameras — a genuinely novel
  # viewpoint of a seen state, the vrig evaluation geometry.
  state_of = [i // cameras_per_state for i in range(num_train)]
  spacing = 2.0 * np.pi / num_frames
  for j in range(num_val):
    mid = (j * num_states) // max(num_val, 1) % num_states
    state_of.append(mid)
    thetas[num_train + j] = (thetas[mid * cameras_per_state]
                             + 0.5 * spacing * cameras_per_state)

  metadata = {}
  for i, (item_id, theta) in enumerate(zip(all_ids, thetas)):
    camera = make_orbit_camera(theta, image_size=image_size)
    camera.save_json(data_dir / 'camera' / f'{item_id}.json')

    mid = state_of[i]
    phase = 2.0 * np.pi * mid / num_states
    offset = motion_amplitude * np.sin(phase)
    image, depth = render_sphere_image(camera,
                                       sphere_center=(offset, 0.0, 0.0),
                                       texture_frequency=texture_frequency,
                                       env_background=env_background,
                                       return_depth=True)
    for scale in image_scales:
      rgb_dir = data_dir / 'rgb' / f'{scale}x'
      rgb_dir.mkdir(parents=True, exist_ok=True)
      scaled = (image if scale == 1
                else image_utils.rescale_image(image, 1.0 / scale))
      image_utils.save_image(rgb_dir / f'{item_id}.png',
                             image_utils.image_to_uint8(scaled))
      if write_depth:
        depth_dir = data_dir / 'depth' / f'{scale}x'
        depth_dir.mkdir(parents=True, exist_ok=True)
        scaled_depth = (depth if scale == 1
                        else image_utils.rescale_depth_image(
                            depth, 1.0 / scale))
        image_utils.save_depth(depth_dir / f'{item_id}.png', scaled_depth)

    metadata[item_id] = {
        'appearance_id': mid,
        'camera_id': 0,
        'warp_id': mid,
        'time_id': mid,
    }

  # Interleave val frames into the orbit.
  val_ids = all_ids[num_train:]
  train_ids = all_ids[:num_train]
  with open(data_dir / 'dataset.json', 'w') as f:
    json.dump({
        'count': num_frames,
        'num_exemplars': num_train,
        'ids': all_ids,
        'train_ids': train_ids,
        'val_ids': val_ids,
    }, f, indent=2)

  with open(data_dir / 'scene.json', 'w') as f:
    json.dump({
        'center': [0.0, 0.0, 0.0],
        'scale': 1.0,
        'near': 1.5,
        # Env-background rays terminate on the ENV_RADIUS sphere, up to
        # |camera| + ENV_RADIUS away — the far plane must reach it or
        # the background is unfittable (and training re-collapses).
        'far': 7.5 if env_background else 4.5,
    }, f, indent=2)

  with open(data_dir / 'metadata.json', 'w') as f:
    json.dump(metadata, f, indent=2)

  # Background points: on-sphere samples away from the moving region.
  rng = np.random.default_rng(seed)
  pts = rng.normal(size=(num_points, 3)).astype(np.float32)
  pts = 1.2 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
  with open(data_dir / 'points.npy', 'wb') as f:
    np.save(f, pts)

  # A small orbit camera path for novel-view rendering.
  for traj in ('orbit-mild', 'orbit-extreme'):
    traj_dir = data_dir / 'camera-paths' / traj
    traj_dir.mkdir(parents=True, exist_ok=True)
    for j, theta in enumerate(np.linspace(0, 2 * np.pi, 6, endpoint=False)):
      camera = make_orbit_camera(theta + 0.1, image_size=image_size)
      camera.save_json(traj_dir / f'{j:06d}.json')

  return data_dir
