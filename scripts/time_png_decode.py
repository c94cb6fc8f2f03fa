"""Times the port's PNG decoder on 1920x1080 frames, on the host CPU.

  python scripts/time_png_decode.py [--frame palette] [--repeats 5]

--frame picks the file, made from the seeded 1920x1080 image of
scripts/time_jpeg_decode.py: `palette`, quantised to 256 colours by
Pillow and saved as an 8-bit palette PNG (what a PNG optimiser or a
screenshot tool writes); `adam7`, an Adam7-interlaced 8-bit RGB PNG
whose rows take the five filters in turn (scripts/write_image_fixtures.py's
writer; Average and Paeth rows take the decoder's wavefront path);
`rgb`, the same image as cv2 writes it (the frames the port itself
writes), for scale. The script decodes it with
`nerfies_tpu_torch.image_utils.decode_png` --repeats times, checks the
pixels against cv2.imdecode bit for bit, and prints one JSON line: the
median and each decode's seconds, cv2's median, the file's bytes and the
CPU model. It needs cv2 and Pillow, so it runs where the JAX package's
tests run, not on the card's machine; the decoder runs on the host only.
"""

import argparse
import io
import json
import pathlib
import sys

import cv2
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from nerfies_tpu_torch import image_utils  # noqa: E402
from time_jpeg_decode import cpu_model, frame, time_decoder  # noqa: E402
from write_image_fixtures import png_bytes  # noqa: E402


def encode(name):
  image = frame()
  if name == 'palette':
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(image).quantize(256).save(out, format='PNG')
    return out.getvalue()
  if name == 'adam7':
    return png_bytes(image, 2, 8, interlace=True)
  ok, data = cv2.imencode('.png', image[..., ::-1])
  assert ok
  return data.tobytes()


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--frame', choices=('palette', 'adam7', 'rgb'),
                      default='palette')
  parser.add_argument('--repeats', type=int, default=5)
  args = parser.parse_args(argv)
  data = encode(args.frame)
  seconds, cv2_seconds = time_decoder(image_utils.decode_png, data,
                                      args.repeats)
  print(json.dumps({
      'frame': f'1920x1080 {args.frame} PNG', 'bytes': len(data),
      'median_s': float(np.median(seconds)), 'seconds': seconds,
      'cv2_median_s': float(np.median(cv2_seconds)),
      'bit_identical_to_cv2': True, 'cpu': cpu_model(),
      'cv2': cv2.__version__}))


if __name__ == '__main__':
  main()
