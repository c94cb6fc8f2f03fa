"""CLI: raw capture video -> nerfies dataset directory, end to end.

The port's counterpart of scripts/process_video.py, with the same flags
(plus --ffprobe_binary): ffmpeg frame extraction with duplicate dropping,
COLMAP SfM, optional face-landmark metric normalization (`--use_face`,
requires `mediapipe`), then scene/near-far/orbit computation and dataset
writing.

  python -m nerfies_tpu_torch.process_video \\
      --video /path/to/capture.mp4 \\
      --workspace /path/to/work \\
      --output_dir /path/to/dataset

Requires the `ffmpeg`, `ffprobe` (for the automatic FPS) and `colmap`
binaries on PATH (override with --ffmpeg_binary, --ffprobe_binary and
--colmap_binary).
"""

import argparse
from pathlib import Path
from typing import Optional, Sequence

from nerfies_tpu_torch import capture
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import video as video_lib
from nerfies_tpu_torch.colmap import runner


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Turns a capture video into a nerfies dataset.')
  parser.add_argument('--video', required=True, help='Source video file.')
  parser.add_argument('--workspace', required=True,
                      help='Working directory (frames + COLMAP outputs).')
  parser.add_argument('--output_dir', required=True,
                      help='Dataset output directory.')
  parser.add_argument('--fps', type=int, default=-1,
                      help='Extraction FPS; -1 auto-computes.')
  parser.add_argument('--target_num_frames', type=int, default=100,
                      help='Approximate frame budget for auto-FPS.')
  parser.add_argument('--max_scale', type=float, default=1.0,
                      help='Downscale frames during extraction.')
  parser.add_argument('--val_fraction', type=float, default=0.2,
                      help='Validation holdout fraction.')
  parser.add_argument('--blur_keep_percentile', type=float, default=95.0,
                      help='Keep this percentile of sharpest frames.')
  parser.add_argument('--match_method', default='exhaustive',
                      choices=['exhaustive', 'vocab_tree'],
                      help='COLMAP matcher.')
  parser.add_argument('--vocab_tree_path', default=None,
                      help='Vocabulary tree for vocab_tree matching.')
  parser.add_argument('--use_face', action=argparse.BooleanOptionalAction,
                      default=False,
                      help='Face-landmark metric normalization (mediapipe).')
  parser.add_argument('--ffmpeg_binary', default='ffmpeg',
                      help='ffmpeg executable.')
  parser.add_argument('--ffprobe_binary', default='ffprobe',
                      help='ffprobe executable.')
  parser.add_argument('--colmap_binary', default='colmap',
                      help='colmap executable.')
  return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Path:
  args = parse_args(argv)
  workspace = Path(args.workspace)
  frames_dir = workspace / 'rgb-raw'

  frames = video_lib.extract_frames(
      args.video, frames_dir, fps=args.fps,
      target_num_frames=args.target_num_frames,
      max_scale=args.max_scale, ffmpeg_binary=args.ffmpeg_binary,
      overwrite=False, ffprobe_binary=args.ffprobe_binary)
  print(f'Extracted {len(frames)} frames to {frames_dir}')

  model_dir = runner.run_sfm(
      frames_dir, workspace / 'colmap',
      colmap_binary=args.colmap_binary,
      match_method=args.match_method,
      vocab_tree_path=args.vocab_tree_path)
  print(f'COLMAP model at {model_dir}')

  images = {p.stem: image_utils.load_image(p) for p in frames}

  face_landmarks = None
  if args.use_face:
    face_landmarks = {}
    for item_id, image in images.items():
      landmarks = capture.compute_face_landmarks(image)
      if landmarks is not None:
        face_landmarks[item_id] = landmarks
    print(f'Found face landmarks in {len(face_landmarks)} frames')

  out = capture.process_capture(
      model_dir, images, args.output_dir,
      val_fraction=args.val_fraction,
      blur_keep_percentile=args.blur_keep_percentile,
      face_landmarks=face_landmarks)
  print(f'Wrote dataset to {out}')
  return out


if __name__ == '__main__':
  main()
