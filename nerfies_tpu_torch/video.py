"""Video-to-frames extraction for capture processing.

Port of nerfies_tpu/video.py (the upstream capture notebook's "Flatten
into images" step): probe the clip, pick an extraction FPS that lands near
a target frame count, and run ffmpeg with an `mpdecimate` filter so
near-duplicate frames (phone captures pause a lot) are dropped before SfM
ever sees them.

ffprobe and ffmpeg run as subprocesses (the JAX package probes through
OpenCV, which the port does not import); nothing here needs a GPU.
"""

import json
import subprocess
from fractions import Fraction
from pathlib import Path
from typing import Sequence


class VideoInfo:
  """Probed clip properties."""

  def __init__(self, fps: float, num_frames: int, width: int, height: int):
    self.fps = fps
    self.num_frames = num_frames
    self.width = width
    self.height = height

  def __repr__(self):
    return (f'VideoInfo(fps={self.fps}, num_frames={self.num_frames}, '
            f'size={self.width}x{self.height})')


def probe_video(video_path, ffprobe_binary: str = 'ffprobe') -> VideoInfo:
  """Reads fps/frame-count/size of the first video stream with ffprobe.

  The frame count is the stream's `nb_frames`, or its duration times its
  rate where the container does not record one (as OpenCV estimates it).
  """
  result = subprocess.run(
      [ffprobe_binary, '-v', 'error', '-select_streams', 'v:0',
       '-show_entries', 'stream=avg_frame_rate,nb_frames,duration,width,'
       'height', '-of', 'json', str(video_path)],
      capture_output=True, text=True)
  if result.returncode != 0:
    raise IOError(f'Could not open video {video_path}: '
                  f'{result.stderr[-2000:]}')
  streams = json.loads(result.stdout).get('streams') or []
  if not streams:
    raise IOError(f'No video stream in {video_path}')
  stream = streams[0]
  fps = float(Fraction(stream['avg_frame_rate']))
  nb_frames = stream.get('nb_frames')
  if nb_frames not in (None, 'N/A'):
    num_frames = int(nb_frames)
  else:
    num_frames = int(round(float(stream['duration']) * fps))
  return VideoInfo(fps=fps, num_frames=num_frames,
                   width=int(stream['width']), height=int(stream['height']))


def compute_extraction_fps(input_fps: float, num_frames: int,
                           target_num_frames: int) -> int:
  """Extraction rate that yields ~`target_num_frames` frames.

  Mirrors the notebook's auto-FPS rule (`fps = target/total * input_fps`);
  raises if the clip is shorter than the target, as the notebook does.
  """
  if num_frames < target_num_frames:
    raise ValueError(
        f'Video has {num_frames} frames, fewer than the target '
        f'{target_num_frames}.')
  return max(1, int(target_num_frames / num_frames * input_fps))


def extraction_filters(max_scale: float = 1.0) -> str:
  """The ffmpeg -vf chain: duplicate-drop, PTS reset, optional scaling."""
  filters = ['mpdecimate', 'setpts=N/FRAME_RATE/TB']
  if max_scale != 1.0:
    filters.append(f'scale=iw*{max_scale}:ih*{max_scale}')
  return ','.join(filters)


def extract_frames(video_path,
                   out_dir,
                   fps: int = -1,
                   target_num_frames: int = 100,
                   max_scale: float = 1.0,
                   ffmpeg_binary: str = 'ffmpeg',
                   overwrite: bool = False,
                   ffprobe_binary: str = 'ffprobe') -> Sequence[Path]:
  """Flattens a video into PNG frames named %06d.png under `out_dir`.

  Args:
    video_path: source clip.
    out_dir: output directory for the frames.
    fps: extraction rate; -1 auto-computes from `target_num_frames`.
    target_num_frames: approximate frame budget for auto-FPS.
    max_scale: spatial downscale applied during extraction.
    ffmpeg_binary: the ffmpeg executable to invoke.
    overwrite: allow writing into a non-empty `out_dir`.
    ffprobe_binary: the ffprobe executable (auto-FPS only).

  Returns:
    Sorted list of written frame paths.
  """
  out_dir = Path(out_dir)
  existing = sorted(out_dir.glob('*.png')) if out_dir.exists() else []
  if existing and not overwrite:
    raise FileExistsError(
        f'{out_dir} already has {len(existing)} frames; pass '
        f'overwrite=True to re-extract.')
  out_dir.mkdir(parents=True, exist_ok=True)

  if fps == -1:
    info = probe_video(video_path, ffprobe_binary)
    fps = compute_extraction_fps(info.fps, info.num_frames,
                                 target_num_frames)

  cmd = [
      ffmpeg_binary, '-y', '-i', str(video_path),
      '-r', str(fps),
      '-vf', extraction_filters(max_scale),
      str(out_dir / '%06d.png'),
  ]
  subprocess.run(cmd, check=True, capture_output=True)
  frames = sorted(out_dir.glob('*.png'))
  if not frames:
    raise RuntimeError(f'ffmpeg produced no frames in {out_dir}')
  return frames
