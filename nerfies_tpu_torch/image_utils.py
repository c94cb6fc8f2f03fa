"""Host-side image utilities: PNG IO, rescaling, conversions.

Port of nerfies_tpu/image_utils.py without OpenCV. The results are those
of the JAX module, whose IO and resizes are cv2's:

  - PNG files are encoded and decoded here with zlib and numpy: 8- and
    16-bit samples (big-endian on disk) in gray, gray+alpha, RGB and RGBA.
    The encoder writes the bytes cv2 writes; the decoder reads all five
    row filters. Interlaced, palette and sub-byte PNGs raise
    ValueError. In memory the channels are RGB(A), as `load_image` returns
    them in the JAX package; gray+alpha decodes to RGBA with the gray
    value repeated, as cv2's IMREAD_UNCHANGED gives it.
  - Resizes follow cv2's interpolation rules: an integer downsampling is
    INTER_AREA's block mean, an upsampling INTER_LINEAR (half-pixel
    centres, edges replicated), a non-integer downsampling INTER_AREA's
    fractional coverage weights, depth INTER_NEAREST. Integer images are
    rounded to nearest, where cv2 rounds fixed-point sums: the two may
    differ by 1.
"""

import math
import struct
import zlib
from typing import Tuple, Union

import numpy as np

UINT8_MAX = 255
UINT16_MAX = 65535

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG colour type -> channels: gray, RGB, gray+alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_COLOR_TYPES = {v: k for k, v in _PNG_CHANNELS.items()}


# ------------------------------------------------------------------ PNG

def _paeth(a, b, c):
  """The Paeth predictor of left a, up b and up-left c (int arrays)."""
  pa = np.abs(b - c)
  pb = np.abs(a - c)
  pc = np.abs(a + b - 2 * c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filters: np.ndarray, rows: np.ndarray,
                   bpp: int) -> np.ndarray:
  """Undoes the None, Sub and Up filters row by row (vectorised in a row)."""
  out = np.empty_like(rows)
  prior = np.zeros(rows.shape[1], np.uint8)
  for r, kind in enumerate(filters):
    row = rows[r]
    if kind == 1:  # Sub: a running sum, mod 256, over each byte lane
      row = np.cumsum(row.reshape(-1, bpp), axis=0,
                      dtype=np.uint8).reshape(-1)
    elif kind == 2:  # Up
      row = row + prior
    out[r] = row
    prior = out[r]
  return out


def _unfilter_wavefront(filters: np.ndarray, rows: np.ndarray,
                        bpp: int) -> np.ndarray:
  """Undoes any mix of the five filters along anti-diagonals.

  Average and Paeth read the decoded pixel to the left, so a row cannot
  be decoded as one vector. Pixel (r, x) reads (r, x-1), (r-1, x) and
  (r-1, x-1), all on earlier anti-diagonals r + x, so each anti-diagonal
  is decoded as one vector: height + width - 1 steps.
  """
  height = rows.shape[0]
  width = rows.shape[1] // bpp
  coded = rows.reshape(height, width, bpp).astype(np.int32)
  # Decoded pixels with a zero row above and a zero column to the left.
  out = np.zeros((height + 1, width + 1, bpp), np.int32)
  kinds = filters.astype(np.int32)
  for t in range(height + width - 1):
    r = np.arange(max(0, t - width + 1), min(height - 1, t) + 1)
    x = t - r
    a = out[r + 1, x]
    b = out[r, x + 1]
    c = out[r, x]
    kind = kinds[r][:, None]
    pred = np.where(kind == 1, a, 0)
    pred = np.where(kind == 2, b, pred)
    pred = np.where(kind == 3, (a + b) >> 1, pred)
    pred = np.where(kind == 4, _paeth(a, b, c), pred)
    out[r + 1, x + 1] = (coded[r, x] + pred) & 0xFF
  return out[1:, 1:].astype(np.uint8).reshape(height, width * bpp)


def decode_png(data: bytes) -> np.ndarray:
  """PNG bytes -> (H, W) or (H, W, C) uint8 / uint16 samples, file order.

  Raises:
    ValueError: not a PNG, or one this decoder does not read (palette,
      interlaced, bit depth other than 8 or 16, a tRNS chunk).
  """
  if data[:8] != _PNG_SIGNATURE:
    raise ValueError('not a PNG file')
  pos, header, idat = 8, None, []
  while pos + 8 <= len(data):
    length, kind = struct.unpack('>I4s', data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + length]
    pos += 12 + length
    if kind == b'IHDR':
      header = struct.unpack('>IIBBBBB', body)
    elif kind == b'IDAT':
      idat.append(body)
    elif kind == b'tRNS':
      raise ValueError('PNG transparency chunks (tRNS) are not supported')
    elif kind == b'IEND':
      break
  if header is None:
    raise ValueError('PNG without an IHDR chunk')
  width, height, depth, color, _, _, interlace = header
  if color not in _PNG_CHANNELS:
    raise ValueError(f'PNG colour type {color} is not supported (palette '
                     'images are not read)')
  if depth not in (8, 16):
    raise ValueError(f'PNG bit depth {depth} is not supported')
  if interlace:
    raise ValueError('interlaced PNGs are not supported')
  channels = _PNG_CHANNELS[color]
  bpp = channels * depth // 8
  stride = width * bpp
  raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
  if raw.size < height * (stride + 1):
    raise ValueError('truncated PNG image data')
  raw = raw[:height * (stride + 1)].reshape(height, stride + 1)
  filters, rows = raw[:, 0], raw[:, 1:]
  if filters.max(initial=0) > 4:
    raise ValueError(f'PNG filter type {filters.max()} is not defined')
  if filters.max(initial=0) <= 2:
    pixels = _unfilter_rows(filters, rows, bpp)
  else:
    pixels = _unfilter_wavefront(filters, rows, bpp)
  if depth == 16:
    pixels = pixels.view('>u2').astype(np.uint16)
  if channels == 1:
    return pixels.reshape(height, width)
  return pixels.reshape(height, width, channels)


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack('>I', len(body)) + kind + body
          + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png_rows(image: np.ndarray):
  """(H, W) or (H, W, 1-4) uint8 / uint16 samples -> (IHDR body, raw rows
  as (H, row bytes) uint8, bytes per pixel)."""
  if image.dtype not in (np.uint8, np.uint16):
    raise ValueError(f'PNG samples must be uint8 or uint16, not '
                     f'{image.dtype}')
  if image.ndim == 2:
    image = image[..., None]
  if image.ndim != 3 or image.shape[-1] not in _PNG_COLOR_TYPES:
    raise ValueError(f'cannot write an image of shape {image.shape} as PNG')
  height, width, channels = image.shape
  depth = 8 * image.dtype.itemsize
  samples = np.ascontiguousarray(image.astype(image.dtype.newbyteorder('>'))
                                 if depth == 16 else image)
  rows = samples.view(np.uint8).reshape(height, width * channels * depth // 8)
  header = struct.pack('>IIBBBBB', width, height, depth,
                       _PNG_COLOR_TYPES[channels], 0, 0, 0)
  return header, rows, channels * depth // 8


def _png(header: bytes, stream: bytes, idat_size: int) -> bytes:
  idats = b''.join(_chunk(b'IDAT', stream[i:i + idat_size])
                   for i in range(0, max(len(stream), 1), idat_size))
  return (_PNG_SIGNATURE + _chunk(b'IHDR', header) + idats
          + _chunk(b'IEND', b''))


def encode_png(image: np.ndarray) -> bytes:
  """PNG bytes equal to those of `cv2.imencode('.png', ...)` with its
  default parameters (OpenCV 5.0, checked against it for every shape and
  depth in tests/test_torch_capture.py), given the channels in RGB(A)
  order: every row Sub-filtered (None for a one-pixel row), zlib level 1
  with the Z_RLE strategy over the smallest window (2^8 to 2^15 bytes)
  that holds the filtered data, the stream's header naming that window,
  IDAT chunks of 8 KiB.
  """
  header, rows, bpp = _png_rows(image)
  height = rows.shape[0]
  filtered = rows.copy()
  filtered[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]
  kind = 1 if rows.shape[1] > bpp else 0
  body = np.concatenate(
      [np.full((height, 1), kind, np.uint8), filtered], axis=1).tobytes()
  wbits = min(15, max(8, (len(body) - 1).bit_length()))
  # zlib refuses a window of 2^8 to deflate; the header still names it.
  compressor = zlib.compressobj(1, zlib.DEFLATED, max(wbits, 9), 8,
                                zlib.Z_RLE)
  stream = compressor.compress(body) + compressor.flush()
  cmf = ((wbits - 8) << 4) | 8
  flg = stream[1] & 0xE0
  flg |= 31 - (cmf * 256 + flg) % 31
  return _png(header, bytes([cmf, flg]) + stream[2:], 8192)


# --------------------------------------------------------------- resizing

def _as_dtype(values: np.ndarray, dtype) -> np.ndarray:
  """Float results -> the input's dtype, rounded and saturated if integer."""
  if np.issubdtype(dtype, np.integer):
    info = np.iinfo(dtype)
    return np.clip(np.rint(values), info.min, info.max).astype(dtype)
  return values.astype(dtype)


def _cv_shape(result: np.ndarray, image: np.ndarray) -> np.ndarray:
  """cv2.resize returns a one-channel (H, W, 1) image as (H, W)."""
  if image.ndim == 3 and image.shape[-1] == 1:
    return result[..., 0]
  return result


def _linear_taps(in_size: int, out_size: int, area_mode: bool):
  """cv2's INTER_LINEAR taps along one axis: (low index, high index,
  weight of the high tap), edges replicated. `area_mode` is the rule
  cv2 uses for INTER_AREA when it upsamples."""
  inv_scale = out_size / in_size
  scale = 1.0 / inv_scale
  dx = np.arange(out_size, dtype=np.float64)
  if area_mode:
    sx = np.floor(dx * scale).astype(np.int64)
    fx = ((dx + 1) - (sx + 1) * inv_scale).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
  else:
    fx = ((dx + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
  fx = np.where(sx < 0, np.float32(0), fx)
  sx = np.maximum(sx, 0)
  fx = np.where(sx >= in_size - 1, np.float32(0), fx)
  sx = np.minimum(sx, in_size - 1)
  return sx, np.minimum(sx + 1, in_size - 1), fx.astype(np.float32)


def _resize_linear(image: np.ndarray, out_height: int, out_width: int,
                   area_mode: bool = False) -> np.ndarray:
  """Separable two-tap interpolation: rows first, then columns, as cv2."""
  work = np.float32 if image.dtype != np.float64 else np.float64
  x = image.astype(work)
  lo, hi, f = _linear_taps(image.shape[1], out_width, area_mode)
  f = f.astype(work).reshape((1, -1) + (1,) * (image.ndim - 2))
  x = x[:, lo] * (1 - f) + x[:, hi] * f
  lo, hi, f = _linear_taps(image.shape[0], out_height, area_mode)
  f = f.astype(work).reshape((-1,) + (1,) * (image.ndim - 1))
  x = x[lo] * (1 - f) + x[hi] * f
  return _cv_shape(_as_dtype(x, image.dtype), image)


def _area_weights(in_size: int, out_size: int) -> np.ndarray:
  """(out, in) coverage weights of cv2's INTER_AREA for a downsampling."""
  scale = in_size / out_size
  weights = np.zeros((out_size, in_size), np.float64)
  for dx in range(out_size):
    fsx1 = dx * scale
    fsx2 = fsx1 + scale
    cell = min(scale, in_size - fsx1)
    sx1 = math.ceil(fsx1)
    sx2 = min(math.floor(fsx2), in_size - 1)
    sx1 = min(sx1, sx2)
    if sx1 - fsx1 > 1e-3:
      weights[dx, sx1 - 1] = (sx1 - fsx1) / cell
    weights[dx, sx1:sx2] = 1.0 / cell
    if fsx2 - sx2 > 1e-3:
      weights[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
  return weights


def _resize_area(image: np.ndarray, out_height: int,
                 out_width: int) -> np.ndarray:
  """cv2's INTER_AREA: a block mean for integer factors, coverage
  weights for others, its upsampling rule where an axis grows."""
  height, width = image.shape[:2]
  if out_height > height or out_width > width:
    return _resize_linear(image, out_height, out_width, area_mode=True)
  if height % out_height == 0 and width % out_width == 0:
    sy, sx = height // out_height, width // out_width
    work = np.float64 if image.dtype == np.float64 else np.float32
    # A block's pixels in row-major order, summed in cv2's order: four
    # at a time, left to right, into a running sum (exact for integers).
    terms = np.moveaxis(image.astype(work).reshape(
        (out_height, sy, out_width, sx) + image.shape[2:]), 2, 1).reshape(
            (out_height, out_width, sy * sx) + image.shape[2:])
    area = sy * sx
    total = np.zeros_like(terms[:, :, 0])
    for k in range(0, area - 3, 4):
      total = total + (((terms[:, :, k] + terms[:, :, k + 1])
                        + terms[:, :, k + 2]) + terms[:, :, k + 3])
    for k in range(area - area % 4, area):
      total = total + terms[:, :, k]
    mean = total * work(1.0 / area)
    return _cv_shape(_as_dtype(mean, image.dtype), image)
  wy = _area_weights(height, out_height)
  wx = _area_weights(width, out_width)
  out = np.einsum('ph,hw...,qw->pq...', wy, image.astype(np.float64), wx)
  return _cv_shape(_as_dtype(out, image.dtype), image)


def _resize_nearest(image: np.ndarray, out_height: int,
                    out_width: int) -> np.ndarray:
  """cv2's INTER_NEAREST: source index floor(dst * in / out), clamped."""
  def index(in_size, out_size):
    inv_scale = out_size / in_size
    step = 1.0 / inv_scale
    src = np.floor(np.arange(out_size) * step).astype(np.int64)
    return np.minimum(src, in_size - 1)
  rows = index(image.shape[0], out_height)
  cols = index(image.shape[1], out_width)
  return _cv_shape(image[rows][:, cols], image)


def make_divisible(image: np.ndarray, divisor: int) -> np.ndarray:
  """Center-crops spatial dims down to multiples of `divisor`."""
  if all(s % divisor == 0 for s in image.shape[:2]):
    return image
  height, width = image.shape[:2]
  new_height = height - height % divisor
  new_width = width - width % divisor
  offset_h = (height - new_height) // 2
  offset_w = (width - new_width) // 2
  return image[offset_h:offset_h + new_height, offset_w:offset_w + new_width]


def downsample_image(image: np.ndarray, scale: int) -> np.ndarray:
  """Anti-aliased integer-factor downsampling (area filter)."""
  if scale == 1:
    return image
  height, width = image.shape[:2]
  if height % scale > 0 or width % scale > 0:
    raise ValueError(f'Image shape ({height},{width}) must be divisible by '
                     f'the scale ({scale}).')
  return _resize_area(image, height // scale, width // scale)


def upsample_image(image: np.ndarray, scale: int) -> np.ndarray:
  """Integer-factor upsampling (bilinear)."""
  if scale == 1:
    return image
  height, width = image.shape[:2]
  return _resize_linear(image, height * scale, width * scale)


def reshape_image(image: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
  """Resizes to an exact (height, width)."""
  out_height, out_width = shape
  if out_height <= image.shape[0]:
    return _resize_area(image, out_height, out_width)
  return _resize_linear(image, out_height, out_width)


def rescale_image(image: np.ndarray, scale_factor: float) -> np.ndarray:
  """Rescales by a factor, preferring exact integer paths."""
  scale_factor = float(scale_factor)
  if scale_factor <= 0.0:
    raise ValueError('scale_factor must be a non-negative number.')
  if scale_factor == 1.0:
    return image
  height, width = image.shape[:2]
  if scale_factor.is_integer():
    return upsample_image(image, int(scale_factor))
  inv_scale = 1.0 / scale_factor
  if (inv_scale.is_integer() and (scale_factor * height).is_integer()
      and (scale_factor * width).is_integer()):
    return downsample_image(image, int(inv_scale))
  out_height = math.ceil(height * scale_factor)
  out_width = math.ceil(width * scale_factor)
  return reshape_image(image, (out_height, out_width))


def rescale_depth_image(depth: np.ndarray,
                        scale_factor: float) -> np.ndarray:
  """Rescales a depth map with nearest-neighbor sampling.

  Bilinear or area filters blend invalid (0) pixels with valid depths at
  silhouette boundaries; nearest keeps every output pixel an input depth.
  """
  scale_factor = float(scale_factor)
  if scale_factor <= 0.0:
    raise ValueError('scale_factor must be a non-negative number.')
  if scale_factor == 1.0:
    return depth
  height, width = depth.shape[:2]
  out_height = math.ceil(height * scale_factor)
  out_width = math.ceil(width * scale_factor)
  return _resize_nearest(depth, out_height, out_width)


def variance_of_laplacian(image: np.ndarray) -> float:
  """Blur metric: variance of the Laplacian response.

  cv2.Laplacian's 3x3 kernel [[0, 1, 0], [1, -4, 1], [0, 1, 0]] over the
  uint8 image, reflect-101 borders, in float64.
  """
  x = image_to_uint8(image).astype(np.float64)
  pad = ((1, 1), (1, 1)) + ((0, 0),) * (x.ndim - 2)
  p = np.pad(x, pad, mode='reflect')
  lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
         - 4.0 * x)
  return float(lap.var())


def image_to_uint8(image: np.ndarray) -> np.ndarray:
  if image.dtype == np.uint8:
    return image
  if not issubclass(image.dtype.type, np.floating):
    raise ValueError(f'Input image should be a floating type but is of type '
                     f'{image.dtype!r}')
  return (image * UINT8_MAX).clip(0.0, UINT8_MAX).astype(np.uint8)


def image_to_uint16(image: np.ndarray) -> np.ndarray:
  if image.dtype == np.uint16:
    return image
  if not issubclass(image.dtype.type, np.floating):
    raise ValueError(f'Input image should be a floating type but is of type '
                     f'{image.dtype!r}')
  return (image * UINT16_MAX).clip(0.0, UINT16_MAX).astype(np.uint16)


def image_to_float32(image: np.ndarray) -> np.ndarray:
  if image.dtype == np.float32:
    return image
  dtype = image.dtype
  if dtype == np.uint8:
    return image.astype(np.float32) / UINT8_MAX
  if dtype == np.uint16:
    return image.astype(np.float32) / UINT16_MAX
  if issubclass(dtype.type, np.floating):
    return image.astype(np.float32)
  raise ValueError(f'Not sure how to handle dtype {dtype}')


def _check_png(path) -> None:
  if not str(path).lower().endswith('.png'):
    raise ValueError(f'only PNG files are read and written: {path}')


def load_image(path) -> np.ndarray:
  """Loads a PNG as uint8 / uint16 gray, RGB or RGBA."""
  _check_png(path)
  with open(path, 'rb') as f:
    image = decode_png(f.read())
  if image.ndim == 3 and image.shape[-1] == 2:
    # Gray+alpha decodes to RGBA, as cv2's IMREAD_UNCHANGED gives it.
    image = image[..., [0, 0, 0, 1]]
  return image


def save_image(path, image: np.ndarray) -> None:
  """Saves uint8 / uint16 gray, gray+alpha, RGB or RGBA as a PNG, in the
  bytes that the JAX package's cv2 writes."""
  _check_png(path)
  data = encode_png(np.asarray(image))
  with open(path, 'wb') as f:
    f.write(data)


def save_depth(path, depth: np.ndarray) -> None:
  """Stores depth (meters) as uint16 millimeters."""
  save_image(path, image_to_uint16(depth / 1000.0))


def load_depth(path) -> np.ndarray:
  depth = load_image(path)
  if depth.dtype != np.uint16:
    raise ValueError('Depth image must be of type uint16.')
  return image_to_float32(depth) * 1000.0


def checkerboard(h: int, w: int, size: int = 8,
                 true_val: Union[float, np.ndarray] = 1.0,
                 false_val: Union[float, np.ndarray] = 0.0) -> np.ndarray:
  """A checkerboard pattern (used to composite alpha renders)."""
  ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
  mask = ((ii // size + jj // size) % 2).astype(bool)
  return np.where(mask[..., None], true_val, false_val)
