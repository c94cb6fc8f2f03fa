"""The port's load_image against the JAX package's (cv2.imdecode with
IMREAD_UNCHANGED, BGR flipped to RGB) on every PNG the format allows and
on RGB, CMYK and YCCK JPEGs: the same dtype, the same shape, equal pixels.

The PNGs are written by `png_bytes` of scripts/write_image_fixtures.py, a
writer of numpy and zlib that shares no code with the decoder (every
colour type at every bit depth, tRNS, Adam7, the five row filters in
turn), and by Pillow; the JPEGs by Pillow (CMYK, its `keep_rgb`). cv2 is
the oracle throughout. The committed fixtures that chip_smoke.py decodes
on the card are held to cv2 here.
"""

import importlib.util
import io
import pathlib

import cv2
import numpy as np
from PIL import Image
import pytest

from nerfies_tpu import image_utils as jax_image_utils
from nerfies_tpu_torch import image_utils
from nerfies_tpu_torch import jpeg

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / 'tests' / 'data' / 'image_fixtures'


def _script():
  spec = importlib.util.spec_from_file_location(
      'write_image_fixtures', REPO / 'scripts' / 'write_image_fixtures.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


fixtures = _script()

# (height, width): an odd size, one that fills every Adam7 pass, and small
# ones that leave passes empty (no rows, no filter bytes).
SIZES = [(45, 61), (8, 8), (3, 5), (1, 1), (1, 9), (6, 2)]
PNG_CASES = [(color, depth, trns, interlace)
             for color, depths in sorted(fixtures.PNG_DEPTHS.items())
             for depth in depths
             for trns in ((False, True) if color in (0, 2, 3) else (False,))
             for interlace in (False, True)]


def _assert_reads_as_jax(path):
  want = jax_image_utils.load_image(path)
  got = image_utils.load_image(path)
  assert got.dtype == want.dtype and got.shape == want.shape, (
      path.name, got.dtype, got.shape, want.dtype, want.shape)
  np.testing.assert_array_equal(got, want, err_msg=path.name)
  return got


def _png_case(color, depth, trns, interlace, height, width, seed):
  rng = np.random.RandomState(seed)
  levels = 1 << depth
  shape = (height, width, fixtures.PNG_CHANNELS[color])
  samples = rng.randint(0, levels, shape)
  palette = alpha = None
  if color == 3:
    # Fewer entries than indices at 8 bits: an index past them is black.
    palette = rng.randint(0, 256, (min(levels, 200), 3))
    if trns:
      alpha = rng.randint(0, 256, max(1, len(palette) // 2))
  elif trns:
    samples[::3, ::2] = samples[0, 0]  # the transparent value recurs
    alpha = samples[0, 0]
  return fixtures.png_bytes(samples[..., 0] if shape[-1] == 1 else samples,
                            color, depth, interlace, palette, alpha)


@pytest.mark.parametrize('color,depth,trns,interlace', PNG_CASES,
                         ids=[f'type{c}-{d}bit{"-trns" if t else ""}'
                              f'{"-adam7" if i else ""}'
                              for c, d, t, i in PNG_CASES])
def test_png_matrix_reads_as_cv2(tmp_path, color, depth, trns, interlace):
  for i, (height, width) in enumerate(SIZES):
    path = tmp_path / f'{height}x{width}.png'
    path.write_bytes(_png_case(color, depth, trns, interlace, height, width,
                               seed=100 * color + depth + i))
    got = _assert_reads_as_jax(path)
    # cv2's rules, named: gray stays 2-D even with tRNS; a palette or RGB
    # gains alpha from tRNS; gray+alpha becomes RGBA.
    channels = {0: 1, 2: 4 if trns else 3, 3: 4 if trns else 3, 4: 4,
                6: 4}[color]
    assert (got.shape[2] if got.ndim == 3 else 1) == channels
    assert got.dtype == (np.uint16 if depth == 16 else np.uint8)


def test_sub_byte_gray_scales_as_libpng(tmp_path):
  """png_set_expand_gray_1_2_4_to_8: each level times 255 / (2^d - 1)."""
  for depth, scale in ((1, 255), (2, 85), (4, 17)):
    levels = np.arange(1 << depth).reshape(1, -1)
    path = tmp_path / f'gray{depth}.png'
    path.write_bytes(fixtures.png_bytes(levels, 0, depth))
    np.testing.assert_array_equal(_assert_reads_as_jax(path), levels * scale)


@pytest.mark.parametrize('bits', [1, 2, 4, 8])
def test_pillow_palette_pngs_read_as_cv2(tmp_path, bits):
  """Another encoder: Pillow's quantiser at each palette depth, opaque and
  with one transparent entry."""
  image = fixtures.sample_image(37, 29, 3, seed=bits)
  for transparency in (None, 1):
    options = {} if transparency is None else {'transparency': transparency}
    path = tmp_path / f'p{bits}_{transparency}.png'
    Image.fromarray(image).quantize(1 << bits).save(path, bits=bits,
                                                    **options)
    _assert_reads_as_jax(path)


def _png_chunks(data):
  chunks, pos = [], 8
  while pos < len(data):
    length = int.from_bytes(data[pos:pos + 4], 'big')
    chunks.append(data[pos:pos + 12 + length])
    pos += 12 + length
  return chunks


def test_trns_chunks_libpng_ignores(tmp_path):
  """tRNS that libpng calls invalid is dropped, as cv2 drops it: longer
  than the palette, empty, before PLTE, after the image data, of the wrong
  length for RGB; and a PLTE in an RGB file is only a suggestion."""
  rng = np.random.RandomState(3)
  indices = rng.randint(0, 4, (9, 7))
  palette = rng.randint(0, 256, (4, 3))
  rgb = rng.randint(0, 256, (9, 7, 3))
  cases = {
      'long': fixtures.png_bytes(indices, 3, 2, palette=palette,
                                 trns=range(6)),
      'empty': fixtures.png_bytes(indices, 3, 2, palette=palette, trns=[]),
      'rgb_short': fixtures.png_bytes(rgb, 2, 8, trns=[1, 2]),
      'rgb_plte': fixtures.png_bytes(rgb, 2, 8, palette=palette),
  }
  ordered = _png_chunks(fixtures.png_bytes(indices, 3, 2, palette=palette,
                                           trns=[9, 10]))
  kinds = [c[4:8] for c in ordered]
  plte, trns, iend = (kinds.index(k) for k in (b'PLTE', b'tRNS', b'IEND'))
  swapped = list(ordered)
  swapped[plte], swapped[trns] = ordered[trns], ordered[plte]
  cases['before_plte'] = fixtures.PNG_SIGNATURE + b''.join(swapped)
  late = [c for c in ordered if c[4:8] != b'tRNS']
  late.insert(iend - 1, ordered[trns])
  cases['after_idat'] = fixtures.PNG_SIGNATURE + b''.join(late)
  for name, data in cases.items():
    path = tmp_path / f'{name}.png'
    path.write_bytes(data)
    assert _assert_reads_as_jax(path).shape == (9, 7, 3), name


def test_pngs_cv2_refuses_raise(tmp_path):
  """Files libpng refuses raise ValueError naming why (and the path, from
  load_image)."""
  rng = np.random.RandomState(4)
  indices = rng.randint(0, 4, (5, 6))
  no_plte = fixtures.png_bytes(indices, 3, 2)
  good = fixtures.png_bytes(indices, 3, 2, palette=rng.randint(0, 256,
                                                               (4, 3)))
  rgb = fixtures.png_bytes(rng.randint(0, 256, (5, 6, 3)), 2, 8)
  ihdr = _png_chunks(rgb)[0]
  # RGB at 4 bits: a combination the format does not define.
  undefined = rgb.replace(ihdr, fixtures._chunk(
      b'IHDR', ihdr[8:16] + bytes([4, 2]) + ihdr[18:21]))
  cases = {'no_plte': (no_plte, 'PLTE'),
           'undefined': (undefined, 'not defined')}
  for name, (data, reason) in cases.items():
    path = tmp_path / f'{name}.png'
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match=f'{name}.png.*{reason}'):
      image_utils.load_image(path)
  # An IDAT stream cut short (with its CRC fixed up).
  chunks = _png_chunks(good)
  idat = next(c for c in chunks if c[4:8] == b'IDAT')
  cut = fixtures._chunk(b'IDAT', idat[8:-4][:-3])
  with pytest.raises(ValueError, match='truncated'):
    image_utils.decode_png(good.replace(idat, cut))


# ------------------------------------------------------------- JPEG

def _jpeg(kind, progressive, height, width, subsampled):
  image = fixtures.sample_image(height, width, 3, seed=height + width)
  options = dict(quality=88, progressive=progressive)
  if kind.startswith('rgb'):
    data = fixtures.pillow_jpeg(image, 'RGB', keep_rgb=True, **options)
    return data if kind == 'rgb_adobe' else fixtures.without_segment(
        data, 0xEE)
  if subsampled:
    options['subsampling'] = 2  # the first component 2x2, the rest 1x1
  data = fixtures.pillow_jpeg(image, 'CMYK', **options)
  transform = {'cmyk': 0, 'ycck': 2, 'ycck_transform1': 1}[kind]
  return fixtures.with_adobe_transform(data, transform)


# ycck_transform1: libjpeg's default_decompress_parms reads any Adobe
# transform but 0 on four components as YCCK.
JPEG_KINDS = ['rgb_adobe', 'rgb_ids', 'cmyk', 'ycck', 'ycck_transform1']


@pytest.mark.parametrize('progressive', [False, True])
@pytest.mark.parametrize('kind', JPEG_KINDS)
def test_jpeg_colour_spaces_read_as_cv2(tmp_path, kind, progressive):
  for height, width in ((45, 61), (48, 64), (1, 1), (17, 2)):
    for subsampled in ((False,) if kind.startswith('rgb')
                       else (False, True)):
      path = tmp_path / f'{height}x{width}_{subsampled}.jpg'
      path.write_bytes(_jpeg(kind, progressive, height, width, subsampled))
      got = _assert_reads_as_jax(path)
      assert got.shape == (height, width, 3)


def test_cmyk_conversion_is_opencvs(tmp_path):
  """cv2's CMYK -> BGR on libjpeg's CMYK output: K - ((255 - X) * K >> 8)
  for X in C, M, Y, checked on a file of flat CMYK blocks whose samples
  survive the JPEG round trip."""
  values = np.array([0, 255, 128, 37], np.uint8)
  cmyk = np.stack(np.meshgrid(values, values, values, values,
                              indexing='ij'), axis=-1).reshape(16, 16, 4)
  blocks = np.repeat(np.repeat(cmyk, 8, axis=0), 8, axis=1)
  out = io.BytesIO()
  Image.fromarray(blocks, 'CMYK').save(out, format='JPEG', quality=100,
                                       subsampling=0)
  path = tmp_path / 'cmyk.jpg'
  path.write_bytes(out.getvalue())
  # libjpeg's CMYK samples: Pillow writes (and reads back) Adobe CMYK
  # inverted.
  c, m, y, k = 255 - np.moveaxis(
      np.asarray(Image.open(path)).astype(np.int64), -1, 0)
  want = np.stack([k - ((255 - x) * k >> 8) for x in (c, m, y)], axis=-1)
  np.testing.assert_array_equal(jpeg.decode_jpeg(out.getvalue()), want)
  _assert_reads_as_jax(path)


# ---------------------------------------------------- committed fixtures

def test_committed_fixtures_equal_cv2_and_the_npz():
  """The files chip_smoke.py decodes on the card, against the pixels it
  holds them to: cv2 gives the npz, and so does the port."""
  pixels = np.load(FIXTURES.with_suffix('.npz'))
  files = sorted(p.name for p in FIXTURES.iterdir())
  assert files == sorted(pixels.files)
  assert set(files) == set(fixtures.fixtures())
  for name in files:
    want = pixels[name]
    cv2_pixels = jax_image_utils.load_image(FIXTURES / name)
    assert cv2_pixels.dtype == want.dtype and cv2_pixels.shape == want.shape
    np.testing.assert_array_equal(cv2_pixels, want, err_msg=name)
    got = image_utils.load_image(FIXTURES / name)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    assert want.shape[0] <= 48 and want.shape[1] <= 64, name
