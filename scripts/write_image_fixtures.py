"""Writes the PNG and JPEG fixtures that the port's image decoders are held to.

  python scripts/write_image_fixtures.py [--out_dir tests/data/image_fixtures]

Each fixture is one kind of frame that cv2.imdecode(IMREAD_UNCHANGED)
reads and that a camera, a photo editor or a PNG optimiser writes:
palette PNGs (with and without tRNS, at 2, 4 and 8 bits), gray at 1, 2
and 4 bits, gray and RGB with tRNS, Adam7-interlaced PNGs, CMYK JPEGs
(sequential, progressive, chroma subsampled), a YCCK JPEG and RGB JPEGs
(an Adobe marker with transform 0, and component ids R, G, B with no
marker). All are at most 64x48. The script writes the files into
--out_dir and cv2's pixels of each, in RGB(A) order as the JAX package's
load_image flips them, into `<out_dir>.npz` under the file's name.
`chip_smoke.py` decodes the files on the card's machine, which has
neither cv2 nor Pillow, and holds them to the npz;
tests/test_torch_image_decode.py holds the npz to cv2.

`png_bytes` is a PNG writer of its own (numpy and zlib, no codec): any
colour type at any bit depth the format allows, a PLTE and a tRNS chunk,
Adam7 interlacing, the five row filters in turn. It writes the files
that neither cv2 nor Pillow writes (sub-byte gray, Adam7), so that the
decoder is held to cv2 on files that its own code did not make.
"""

import argparse
import io
import pathlib
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# Colour type -> channels on disk: gray, RGB, palette, gray+alpha, RGBA.
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}
# Adam7's passes: (first row, first column, row step, column step).
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))

OUT_DIR = pathlib.Path(__file__).resolve().parent.parent / 'tests' / 'data' \
    / 'image_fixtures'


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack('>I', len(body)) + kind + body
          + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
  pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_rows(samples: np.ndarray, depth: int, first_filter: int):
  """(h, w, c) samples -> the filtered scanlines of one (sub-)image, row r
  with filter type (first_filter + r) % 5."""
  height, width, channels = samples.shape
  if height == 0 or width == 0:
    return b''
  flat = samples.reshape(height, width * channels)
  if depth == 16:
    raw = flat.astype('>u2').view(np.uint8).reshape(height, -1)
  elif depth == 8:
    raw = flat.astype(np.uint8)
  else:  # packed from the high bit down, the last byte padded with zeros
    bits = np.unpackbits(flat.astype(np.uint8)[..., None],
                         axis=-1)[..., 8 - depth:]
    raw = np.packbits(bits.reshape(height, -1), axis=1)
  bpp = max(1, channels * depth // 8)
  x = raw.astype(np.int32)
  up = np.concatenate([np.zeros_like(x[:1]), x[:-1]])
  left = np.concatenate([np.zeros_like(x[:, :bpp]), x[:, :-bpp]], axis=1)
  up_left = np.concatenate([np.zeros_like(x[:, :bpp]), up[:, :-bpp]], axis=1)
  predictions = (np.zeros_like(x), left, up, (left + up) >> 1,
                 _paeth(left, up, up_left))
  kinds = (np.arange(height) + first_filter) % 5
  rows = [(x[r] - predictions[k][r]) & 0xFF for r, k in enumerate(kinds)]
  return np.concatenate([kinds[:, None], np.stack(rows)],
                        axis=1).astype(np.uint8).tobytes()


def png_bytes(samples, color: int, depth: int, interlace: bool = False,
              palette=None, trns=None) -> bytes:
  """A PNG of `samples` ((H, W) or (H, W, channels) integers as stored on
  disk: palette indices for colour type 3) at `depth` bits. `palette` is
  (n, 3) RGB; `trns` the alpha of the first palette entries, or the
  transparent gray value or RGB colour."""
  samples = np.asarray(samples)
  if samples.ndim == 2:
    samples = samples[..., None]
  height, width, channels = samples.shape
  if channels != PNG_CHANNELS[color] or depth not in PNG_DEPTHS[color]:
    raise ValueError(f'colour type {color} at {depth} bits cannot hold '
                     f'{channels} channels')
  if interlace:
    data = b''.join(_filtered_rows(samples[r0::dr, c0::dc], depth, i)
                    for i, (r0, c0, dr, dc) in enumerate(ADAM7))
  else:
    data = _filtered_rows(samples, depth, 0)
  out = PNG_SIGNATURE + _chunk(b'IHDR', struct.pack(
      '>IIBBBBB', width, height, depth, color, 0, 0, int(interlace)))
  if palette is not None:
    out += _chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
  if trns is not None:
    dtype = np.uint8 if color == 3 else '>u2'
    out += _chunk(b'tRNS', np.asarray(trns, dtype).tobytes())
  return out + _chunk(b'IDAT', zlib.compress(data)) + _chunk(b'IEND', b'')


def sample_image(height: int, width: int, channels: int = 3,
                 seed: int = 0) -> np.ndarray:
  """Seeded uint8 ramps with noise: texture a quantiser and a JPEG
  encoder do real work on."""
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[:height, :width]
  ramps = np.stack([np.sin(xx / 5.0) * 80 + yy * 3.0 + 40,
                    np.cos(yy / 4.0) * 70 + xx * 2.0 + 60,
                    (xx + yy) * 3.0 + 20,
                    255 - xx * 2.0 - yy], axis=-1)[..., :channels]
  image = ramps + rng.randint(-30, 30, ramps.shape)
  return np.clip(image, 0, 255).astype(np.uint8)


def pillow_palette_png(image: np.ndarray, colors: int, **options) -> bytes:
  """`image` quantised to `colors` entries by Pillow, saved as a PNG."""
  from PIL import Image
  out = io.BytesIO()
  Image.fromarray(image).quantize(colors).save(out, format='PNG', **options)
  return out.getvalue()


def pillow_jpeg(image: np.ndarray, mode: str, **options) -> bytes:
  from PIL import Image
  out = io.BytesIO()
  Image.fromarray(image).convert(mode).save(out, format='JPEG', **options)
  return out.getvalue()


def jpeg_segment(data: bytes, marker: int) -> slice:
  """The bytes of the first marker segment `marker` (FF included)."""
  i = 2
  while data[i + 1] != marker:
    i += 2 + int.from_bytes(data[i + 2:i + 4], 'big')
  return slice(i, i + 2 + int.from_bytes(data[i + 2:i + 4], 'big'))


def with_adobe_transform(data: bytes, transform: int) -> bytes:
  """`data` with the transform byte (the last) of its Adobe APP14 set."""
  out = bytearray(data)
  out[jpeg_segment(data, 0xEE).stop - 1] = transform
  return bytes(out)


def without_segment(data: bytes, marker: int) -> bytes:
  cut = jpeg_segment(data, marker)
  return data[:cut.start] + data[cut.stop:]


def fixtures() -> dict:
  """{file name: bytes} of every fixture."""
  rng = np.random.RandomState(0)
  h, w = 45, 61
  rgb = sample_image(h, w, 3, seed=1)
  palette = rng.randint(0, 256, (256, 3))
  out = {
      'palette8.png': png_bytes(rng.randint(0, 256, (h, w)), 3, 8,
                                palette=palette),
      'palette4_trns.png': png_bytes(rng.randint(0, 16, (h, w)), 3, 4,
                                     palette=palette[:16],
                                     trns=rng.randint(0, 256, 9)),
      'gray1.png': png_bytes(rng.randint(0, 2, (h, w)), 0, 1),
      'gray2.png': png_bytes(rng.randint(0, 4, (h, w)), 0, 2),
      'gray4_trns.png': png_bytes(rng.randint(0, 16, (h, w)), 0, 4,
                                  trns=[5]),
      'gray16_trns.png': png_bytes(rng.randint(0, 65536, (h, w)), 0, 16,
                                   trns=[1000]),
  }
  for depth in (8, 16):
    samples = rng.randint(0, 1 << depth, (h, w, 3))
    samples[::3, ::2] = samples[0, 0]
    out[f'rgb{depth}_trns.png'] = png_bytes(samples, 2, depth,
                                            trns=samples[0, 0])
  out['pillow_palette4_trns.png'] = pillow_palette_png(rgb, 16, bits=4,
                                                      transparency=3)
  out['adam7_rgb8.png'] = png_bytes(rgb, 2, 8, interlace=True)
  out['adam7_palette2_trns.png'] = png_bytes(
      rng.randint(0, 4, (h, w)), 3, 2, interlace=True, palette=palette[:4],
      trns=[0, 128])
  out['adam7_gray_alpha16.png'] = png_bytes(
      rng.randint(0, 65536, (h, w, 2)), 4, 16, interlace=True)
  cmyk = pillow_jpeg(rgb, 'CMYK', quality=90)
  out['cmyk.jpg'] = cmyk
  out['cmyk_progressive.jpg'] = pillow_jpeg(rgb, 'CMYK', quality=90,
                                            progressive=True)
  out['ycck_subsampled.jpg'] = with_adobe_transform(
      pillow_jpeg(rgb, 'CMYK', quality=90, subsampling=2), 2)
  rgb_jpeg = pillow_jpeg(rgb, 'RGB', quality=90, keep_rgb=True)
  out['rgb_adobe.jpg'] = rgb_jpeg
  out['rgb_ids.jpg'] = without_segment(rgb_jpeg, 0xEE)
  return out


def cv2_pixels(data: bytes) -> np.ndarray:
  """cv2.imdecode(IMREAD_UNCHANGED) with BGR(A) flipped to RGB(A): the
  JAX package's load_image."""
  import cv2
  image = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
  if image is None:
    raise ValueError('cv2 does not decode this file')
  if image.ndim == 3:
    image[..., :3] = image[..., 2::-1]
  return image


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--out_dir', type=pathlib.Path, default=OUT_DIR)
  args = parser.parse_args(argv)
  args.out_dir.mkdir(parents=True, exist_ok=True)
  pixels = {}
  for name, data in fixtures().items():
    (args.out_dir / name).write_bytes(data)
    pixels[name] = cv2_pixels(data)
    print(f'{name}: {len(data)} bytes, {pixels[name].dtype} '
          f'{pixels[name].shape}')
  np.savez_compressed(args.out_dir.with_suffix('.npz'), **pixels)


if __name__ == '__main__':
  main()
