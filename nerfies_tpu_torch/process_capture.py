"""CLI: convert a COLMAP reconstruction + frames into a nerfies dataset.

The port's counterpart of scripts/process_capture.py, with the same flags
and defaults (after COLMAP has run; `python -m
nerfies_tpu_torch.process_video` runs ffmpeg and COLMAP too):

  python -m nerfies_tpu_torch.process_capture \\
      --colmap_dir /path/to/capture/sparse/0 \\
      --images_dir /path/to/capture/rgb-raw \\
      --output_dir /path/to/dataset

Frames are read as PNG (the port decodes no JPEG). Everything runs on the
host; the dataset it writes is the JAX package's, byte for byte.
"""

import argparse
from pathlib import Path
from typing import Optional, Sequence

from nerfies_tpu_torch import capture
from nerfies_tpu_torch import image_utils


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(
      description='Converts a COLMAP model and its frames into a nerfies '
      'dataset.')
  parser.add_argument('--colmap_dir', required=True,
                      help='COLMAP sparse model directory.')
  parser.add_argument('--images_dir', required=True,
                      help='Directory of source frames.')
  parser.add_argument('--output_dir', required=True,
                      help='Dataset output directory.')
  parser.add_argument('--val_fraction', type=float, default=0.2,
                      help='Validation holdout fraction.')
  parser.add_argument('--blur_keep_percentile', type=float, default=95.0,
                      help='Keep this percentile of sharpest frames.')
  parser.add_argument('--orbit_frames', type=int, default=60,
                      help='Frames per orbit camera path.')
  return parser.parse_args(argv)


def load_frames(images_dir) -> dict:
  """{stem: image} of the frames in `images_dir`, sorted by name."""
  images_dir = Path(images_dir)
  images = {}
  for path in sorted(images_dir.iterdir()):
    if path.suffix.lower() in ('.png', '.jpg', '.jpeg'):
      images[path.stem] = image_utils.load_image(path)
  return images


def main(argv: Optional[Sequence[str]] = None) -> Path:
  args = parse_args(argv)
  images = load_frames(args.images_dir)
  print(f'Loaded {len(images)} frames from {args.images_dir}')
  out = capture.process_capture(
      args.colmap_dir,
      images,
      args.output_dir,
      val_fraction=args.val_fraction,
      blur_keep_percentile=args.blur_keep_percentile,
      orbit_frames=args.orbit_frames)
  print(f'Wrote dataset to {out}')
  return out


if __name__ == '__main__':
  main()
