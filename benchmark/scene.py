"""The one traffic generator: a synthetic capture made in memory from the seed.

A traffic mix is a JSON file under traffic/ whose parameters this module
reads; a configuration fixes the frame size. Everything here is numpy on
the host (the frames a capture would hold) or plain camera parameters;
nothing comes from the program.

Cameras are pinholes on a circle around the origin, looking at it, in
OpenCV's convention (x right, y down, z forward), with no skew or
distortion. Frames are smooth colour fields drawn from the seed: their
content changes with the seed, their sizes and the work they make never.
"""

import dataclasses
import math
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Camera:
  """A pinhole camera: world-to-camera `orientation`, `position`, pixels."""
  orientation: np.ndarray  # (3, 3)
  position: np.ndarray  # (3,)
  focal_length: float
  width: int
  height: int

  @property
  def image_shape(self):
    return (self.height, self.width)

  @property
  def principal_point(self) -> np.ndarray:
    return np.asarray([self.width / 2.0, self.height / 2.0], np.float32)

  def ray_parameters(self) -> Dict[str, np.ndarray]:
    """The parameters of a full OpenCV camera, distortion zero."""
    return {
        'orientation': self.orientation,
        'position': self.position,
        'focal_length': np.float32(self.focal_length),
        'principal_point': self.principal_point,
        'skew': np.float32(0.0),
        'pixel_aspect_ratio': np.float32(1.0),
        'radial_distortion': np.zeros(3, np.float32),
        'tangential_distortion': np.zeros(2, np.float32),
    }

  def directions(self) -> np.ndarray:
    """(H, W, 3) unit world directions through the pixel centres."""
    px = np.arange(self.width, dtype=np.float32) + 0.5
    py = np.arange(self.height, dtype=np.float32) + 0.5
    x = (px[None, :] - self.width / 2.0) / self.focal_length
    y = (py[:, None] - self.height / 2.0) / self.focal_length
    local = np.stack(np.broadcast_arrays(x, y, np.ones_like(x)), axis=-1)
    local /= np.linalg.norm(local, axis=-1, keepdims=True)
    world = local @ self.orientation.astype(np.float32)
    world /= np.linalg.norm(world, axis=-1, keepdims=True)
    return world.astype(np.float32)


def orbit_camera(theta: float, traffic: Dict, width: int,
                 height: int) -> Camera:
  """A camera on the traffic's orbit at angle `theta`, facing the origin."""
  radius, lift = traffic['orbit_radius'], traffic['orbit_height']
  position = np.asarray([radius * math.cos(theta), lift,
                         radius * math.sin(theta)], np.float32)
  forward = -position / np.linalg.norm(position)
  right = np.cross(forward, np.asarray([0.0, 1.0, 0.0], np.float32))
  right /= np.linalg.norm(right)
  down = np.cross(forward, right)
  orientation = np.stack([right, down, forward]).astype(np.float32)
  return Camera(orientation, position,
                traffic['focal_fraction'] * width, width, height)


def frame_ids(index: int, num_ids: Dict[str, int]) -> Dict[str, int]:
  """The metadata ids of frame `index`: each table taken in turn."""
  return {k: index % n for k, n in num_ids.items()}


def _colour_field(rng, height: int, width: int) -> np.ndarray:
  """(H, W, 3) uint8: a sum of three random plane waves a channel."""
  y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
  x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
  out = np.empty((height, width, 3), np.float32)
  for c in range(3):
    fx, fy, phase = rng.uniform(-12.0, 12.0, 3), rng.uniform(-12.0, 12.0, 3), \
        rng.uniform(0.0, 2 * math.pi, 3)
    field = sum(np.sin(fx[k] * x + fy[k] * y + phase[k]) for k in range(3))
    out[..., c] = 0.5 + field / 6.0
  return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


@dataclasses.dataclass
class Capture:
  """The training frames as flat per-ray arrays and per-frame tables."""
  directions: np.ndarray  # (N, 3) float32
  rgb: np.ndarray  # (N, 3) uint8
  image_idx: np.ndarray  # (N,) int32
  origins: np.ndarray  # (M, 3) float32
  metadata: Dict[str, np.ndarray]  # {key: (M, 1) uint32}
  points: np.ndarray  # (P, 3) float32 background points


def capture(traffic: Dict, scene: Dict, num_ids: Dict[str, int],
            seed: int) -> Capture:
  """The training capture of a `train` traffic mix at the scene's size."""
  rng = np.random.default_rng(seed)
  frames = traffic['pool_frames']
  width, height = scene['image_width'], scene['image_height']
  thetas = (2 * math.pi * np.arange(frames) / frames
            + rng.uniform(0.0, 2 * math.pi / frames, frames))
  directions, rgb = [], []
  origins = np.zeros((frames, 3), np.float32)
  metadata = {k: np.zeros((frames, 1), np.uint32) for k in num_ids}
  for i, theta in enumerate(thetas):
    camera = orbit_camera(float(theta), traffic, width, height)
    directions.append(camera.directions().reshape(-1, 3))
    rgb.append(_colour_field(rng, height, width).reshape(-1, 3))
    origins[i] = camera.position
    for k, v in frame_ids(i, num_ids).items():
      metadata[k][i, 0] = v
  n = width * height
  points = (traffic['points_scale'] * rng.standard_normal(
      (traffic['background_points'], 3))).astype(np.float32)
  return Capture(np.concatenate(directions), np.concatenate(rgb),
                 np.repeat(np.arange(frames, dtype=np.int32), n), origins,
                 metadata, points)


def render_path(traffic: Dict, scene: Dict, num_ids: Dict[str, int],
                seed: int) -> List:
  """[(camera, metadata ids)] of a `render` mix: frames along the orbit,
  from a start angle drawn from the seed."""
  rng = np.random.default_rng(seed)
  start = rng.uniform(0.0, 2 * math.pi)
  count = traffic['path_frames']
  return [(orbit_camera(start + 2 * math.pi * k / count, traffic,
                        scene['image_width'], scene['image_height']),
           frame_ids(k, num_ids)) for k in range(count)]
