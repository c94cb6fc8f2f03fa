"""Times the port's JPEG decoder on camera-sized frames, on the host CPU.

  python scripts/time_jpeg_decode.py [--frame 1080p] [--repeats 5]
      [--quality 95] [--progressive]

--frame picks the file: `1080p`, a seeded 1920x1080 RGB image (smooth
ramps and noise, like a phone frame's texture) written by cv2.imencode
at --quality with 4:2:0 chroma sampling, sequential or --progressive;
`12mp`, the same texture at 4032x3024, a 12 MP phone camera's frame;
`cmyk_1080p`, the 1080p image converted to CMYK by Pillow and saved as
an Adobe CMYK JPEG at --quality (what a photo editor exports). The
script decodes it with `nerfies_tpu_torch.jpeg.decode_jpeg` --repeats
times, checks the pixels against cv2.imdecode bit for bit, and prints
one JSON line: the median and each decode's seconds, cv2's median for
scale, the file's bytes and the CPU model. It needs cv2 (and Pillow for
CMYK), so it runs where the JAX package's tests run, not on the card's
machine; the decoder runs on the host only.
"""

import argparse
import io
import json
import pathlib
import platform
import sys
import time

import cv2
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from nerfies_tpu_torch import jpeg  # noqa: E402


# --frame -> (height, width).
FRAMES = {'1080p': (1080, 1920), '12mp': (3024, 4032),
          'cmyk_1080p': (1080, 1920)}


def frame(height=1080, width=1920, seed=0):
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[:height, :width]
  ramps = np.stack([np.sin(xx / 40.0) * 80 + yy / 9.0,
                    np.cos(yy / 30.0) * 70 + xx / 15.0,
                    (xx + yy) / 12.0], axis=-1)
  return np.clip(ramps + rng.normal(0, 6, ramps.shape), 0,
                 255).astype(np.uint8)


def cpu_model():
  try:
    for line in pathlib.Path('/proc/cpuinfo').read_text().splitlines():
      if line.startswith('model name'):
        return line.split(':', 1)[1].strip()
  except OSError:
    pass
  return platform.processor() or 'unknown'


def encode(name, quality, progressive):
  """The JPEG bytes of frame `name`."""
  image = frame(*FRAMES[name])
  if name == 'cmyk_1080p':
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(image).convert('CMYK').save(
        out, format='JPEG', quality=quality, progressive=progressive)
    return out.getvalue()
  ok, data = cv2.imencode('.jpg', image, [
      cv2.IMWRITE_JPEG_QUALITY, quality,
      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
      cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
  assert ok
  return data.tobytes()


def time_decoder(decode, data, repeats):
  """Decodes `data` `repeats` times with `decode` and with cv2; raises
  SystemExit unless each decode equals cv2's (in RGB order). Returns both
  lists of seconds."""
  want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
  if want.ndim == 3:
    want[..., :3] = want[..., 2::-1]
  seconds, cv2_seconds = [], []
  for _ in range(repeats):
    start = time.perf_counter()
    got = decode(data)
    seconds.append(time.perf_counter() - start)
    start = time.perf_counter()
    cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    cv2_seconds.append(time.perf_counter() - start)
    if got.dtype != want.dtype or not np.array_equal(got, want):
      raise SystemExit('the decoder disagrees with cv2')
  return seconds, cv2_seconds


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--frame', choices=sorted(FRAMES), default='1080p')
  parser.add_argument('--repeats', type=int, default=5)
  parser.add_argument('--quality', type=int, default=95)
  parser.add_argument('--progressive', action='store_true')
  args = parser.parse_args(argv)
  data = encode(args.frame, args.quality, args.progressive)
  seconds, cv2_seconds = time_decoder(jpeg.decode_jpeg, data, args.repeats)
  height, width = FRAMES[args.frame]
  print(json.dumps({
      'frame': f'{width}x{height} '
               + ('CMYK' if args.frame == 'cmyk_1080p' else '4:2:0'),
      'quality': args.quality,
      'progressive': args.progressive, 'bytes': len(data),
      'median_s': float(np.median(seconds)), 'seconds': seconds,
      'cv2_median_s': float(np.median(cv2_seconds)),
      'bit_identical_to_cv2': True, 'cpu': cpu_model(),
      'cv2': cv2.__version__}))


if __name__ == '__main__':
  main()
