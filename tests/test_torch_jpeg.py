"""The port's JPEG decoder against cv2.imdecode(IMREAD_UNCHANGED), bit for bit.

Every JPEG here is written by cv2.imencode (libjpeg-turbo) from a seeded
numpy image: smooth colour ramps with noise, and pure noise. The decoder
must give cv2's pixels exactly (colour in RGB, as the JAX package's
load_image flips cv2's BGR) over quality, chroma sampling, progressive or
sequential coding, restart intervals and sizes whose edges cut MCUs.
"""

import itertools

import cv2
import numpy as np
import pytest

from nerfies_tpu import image_utils as jax_image_utils
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import jpeg

SAMPLING = {
    '444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
# (height, width): 1, 2 and 17 on each side, and sizes that leave part
# MCUs at both edges for every sampling.
SIZES = [(1, 1), (2, 2), (17, 17), (1, 17), (17, 2), (2, 1), (33, 23),
         (40, 64)]


def _image(height, width, channels, seed, noise_only=False):
  rng = np.random.RandomState(seed)
  if noise_only:
    image = rng.randint(0, 256, (height, width, channels))
  else:
    yy, xx = np.mgrid[:height, :width]
    ramps = np.stack([np.sin(xx / 5.0) * 80 + yy * 3.0,
                      np.cos(yy / 4.0) * 70 + xx * 2.0,
                      (xx + yy) * 4.0 - 40.0], axis=-1)[..., :channels]
    image = ramps + rng.randint(-30, 30, (height, width, channels))
  image = np.clip(image, 0, 255).astype(np.uint8)
  return image[..., 0] if channels == 1 else image


def _encode(image, quality=95, sampling='420', progressive=False,
            restart=0):
  ok, data = cv2.imencode('.jpg', image, [
      cv2.IMWRITE_JPEG_QUALITY, quality,
      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
      cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
      cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
  assert ok
  return data.tobytes()


def _cv2_rgb(data):
  image = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
  return image[..., ::-1] if image.ndim == 3 else image


def _assert_decodes_as_cv2(data):
  want = _cv2_rgb(data)
  got = jpeg.decode_jpeg(data)
  assert got.dtype == np.uint8 and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('restart', [0, 1])
@pytest.mark.parametrize('progressive', [False, True])
@pytest.mark.parametrize('sampling', list(SAMPLING))
@pytest.mark.parametrize('quality', [50, 95, 100])
def test_colour_jpegs_equal_cv2(quality, sampling, progressive, restart):
  for i, (height, width) in enumerate(SIZES):
    image = _image(height, width, 3, seed=i + quality)
    _assert_decodes_as_cv2(_encode(image, quality, sampling, progressive,
                                   restart))


@pytest.mark.parametrize('restart', [0, 1])
@pytest.mark.parametrize('progressive', [False, True])
@pytest.mark.parametrize('quality', [50, 95, 100])
def test_gray_jpegs_equal_cv2(quality, progressive, restart):
  for i, (height, width) in enumerate(SIZES):
    image = _image(height, width, 1, seed=i + quality)
    data = _encode(image, quality, '444', progressive, restart)
    assert jpeg.decode_jpeg(data).ndim == 2
    _assert_decodes_as_cv2(data)


@pytest.mark.parametrize('sampling', list(SAMPLING))
def test_noise_and_saturated_edges_equal_cv2(sampling):
  """Pure noise and black/white checks: coefficients at their extremes,
  IDCT outputs past [0, 255] and long Huffman codes."""
  rng = np.random.RandomState(7)
  for quality, progressive, restart in itertools.product(
      (10, 75, 100), (False, True), (0, 3)):
    height, width = rng.randint(9, 70, size=2)
    noise = _image(height, width, 3, seed=quality, noise_only=True)
    check = ((np.indices((height, width)).sum(0) % 2) * 255).astype(
        np.uint8)
    for image in (noise, np.repeat(check[..., None], 3, axis=-1)):
      _assert_decodes_as_cv2(_encode(image, quality, sampling, progressive,
                                     restart))


def test_load_image_reads_jpegs_as_jax_does(tmp_path):
  colour = _image(37, 51, 3, seed=1)
  gray = _image(37, 51, 1, seed=2)
  for name, image in (('a.jpg', colour), ('b.JPEG', gray),
                      ('c.jpeg', colour)):
    (tmp_path / name).write_bytes(_encode(image, progressive=name[0] == 'c'))
    np.testing.assert_array_equal(image_utils.load_image(tmp_path / name),
                                  jax_image_utils.load_image(tmp_path / name))
  # The content decides, as in cv2: a PNG named .jpg reads as a PNG.
  (tmp_path / 'png.jpg').write_bytes(image_utils.encode_png(colour))
  np.testing.assert_array_equal(image_utils.load_image(tmp_path / 'png.jpg'),
                                colour)
  with pytest.raises(ValueError, match='only PNG files are written'):
    image_utils.save_image(tmp_path / 'out.jpg', colour)


def test_unknown_content_raises_naming_the_path(tmp_path):
  path = tmp_path / 'frame.jpg'
  path.write_bytes(b'GIF89a' + bytes(64))
  with pytest.raises(ValueError, match='neither a PNG nor a JPEG.*frame.jpg'):
    image_utils.load_image(path)
  with pytest.raises(ValueError, match='not a JPEG'):
    jpeg.decode_jpeg(b'\x89PNG' + bytes(16))


@pytest.mark.parametrize('progressive', [False, True])
def test_truncated_jpegs_raise(tmp_path, progressive):
  data = _encode(_image(40, 56, 3, seed=3), progressive=progressive,
                 restart=2)
  for cut in (3, 20, len(data) // 3, len(data) // 2, len(data) - 2):
    with pytest.raises(ValueError, match='truncated|corrupt'):
      jpeg.decode_jpeg(data[:cut])
  path = tmp_path / 'cut.jpg'
  path.write_bytes(data[:len(data) // 2])
  with pytest.raises(ValueError, match='cut.jpg.*truncated'):
    image_utils.load_image(path)


def _segment(data, marker):
  """The offset of the first marker segment of `marker` (its FF byte)."""
  i = 2
  while data[i + 1] != marker:
    i += 2 + int.from_bytes(data[i + 2:i + 4], 'big')
  return i


def _with_frame(data, marker=None, precision=None, ids=None):
  """`data` (sequential) with its SOF marker, precision or component ids
  replaced (the ids in the scan header too)."""
  sof = _segment(data, 0xC0)
  sos = _segment(data, 0xDA)
  out = bytearray(data)
  if marker is not None:
    out[sof + 1] = marker
  if precision is not None:
    out[sof + 4] = precision
  if ids is not None:
    for i, cid in enumerate(ids):
      out[sof + 10 + 3 * i] = cid
      out[sos + 5 + 2 * i] = cid
  return bytes(out)


def _without_jfif(data):
  app0 = _segment(data, 0xE0)
  length = int.from_bytes(data[app0 + 2:app0 + 4], 'big')
  return data[:app0] + data[app0 + 2 + length:]


def test_rgb_component_ids_equal_cv2():
  """Component ids R, G, B with no JFIF marker mean untransformed RGB,
  whose planes libjpeg copies through; with the JFIF marker the same ids
  still mean YCbCr, as in libjpeg's default_decompress_parms."""
  data = _encode(_image(16, 16, 3, seed=5))
  _assert_decodes_as_cv2(_with_frame(data, ids=(82, 71, 66)))
  _assert_decodes_as_cv2(_with_frame(_without_jfif(data), ids=(82, 71, 66)))


@pytest.mark.parametrize('kind,edit', [
    ('arithmetic', lambda d: _with_frame(d, marker=0xC9)),
    ('lossless', lambda d: _with_frame(d, marker=0xC3)),
    ('12-bit', lambda d: _with_frame(d, precision=12)),
])
def test_unsupported_jpegs_raise(tmp_path, kind, edit):
  """Kinds no encoder here writes (cv2 and Pillow write none of them):
  each raises naming its kind, and load_image names the path too."""
  data = edit(_encode(_image(16, 16, 3, seed=5)))
  with pytest.raises(ValueError, match=kind):
    jpeg.decode_jpeg(data)
  path = tmp_path / 'frame.jpg'
  path.write_bytes(data)
  with pytest.raises(ValueError, match=f'frame.jpg.*{kind}'):
    image_utils.load_image(path)


@pytest.mark.parametrize('progressive', [False, True])
def test_exif_thumbnails_and_optimized_tables_equal_cv2(progressive):
  """A phone frame's shape: an APP1 Exif segment that holds a JPEG
  thumbnail (its own SOI/EOI markers, skipped with the segment), Huffman
  tables optimised for the image, chroma quantised apart from luma."""
  image = _image(45, 61, 3, seed=8)
  ok, data = cv2.imencode('.jpg', image, [
      cv2.IMWRITE_JPEG_QUALITY, 92, cv2.IMWRITE_JPEG_CHROMA_QUALITY, 70,
      cv2.IMWRITE_JPEG_OPTIMIZE, 1,
      cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
  assert ok
  data = data.tobytes()
  thumbnail = _encode(_image(8, 8, 3, seed=9))
  body = b'Exif\x00\x00' + bytes(10) + thumbnail
  app1 = b'\xff\xe1' + (len(body) + 2).to_bytes(2, 'big') + body
  _assert_decodes_as_cv2(data[:2] + app1 + data[2:])
