"""A JPEG decoder in numpy, bit for bit libjpeg's with its default settings.

`image_utils.load_image` decodes `.jpg` frames here, where the JAX package
calls `cv2.imdecode(..., IMREAD_UNCHANGED)`, whose JPEG reader is
libjpeg-turbo with libjpeg's defaults: the integer ("islow") IDCT, fancy
upsampling and no EXIF rotation. Each stage below is libjpeg's integer
arithmetic:

  - entropy decoding: baseline and extended sequential Huffman scans
    (interleaved or not) and progressive ones (DC first and refine, AC
    first and refine, EOB runs), restart intervals;
  - dequantisation in integers, then `jidctint.c`'s islow IDCT (13-bit
    constants, 2 extra bits in the column pass, rounded shifts), its
    output through the `range_limit` table's `& 1023` wraparound;
  - upsampling as `jdsample.c` does it: the triangle filter with its
    alternating rounding for h2v1 and h2v2 (box when the downsampled width
    is 2 or less) and h1v2, box for any other integer ratio; a
    component's edge samples repeat past its downsampled width and
    height;
  - the colour space by `default_decompress_parms`' rule (jdapimin.c):
    one component is gray; three are YCbCr under a JFIF marker, RGB under
    an Adobe marker of transform 0 (YCbCr under any other), else RGB if
    the component ids are R, G, B and YCbCr otherwise; four are CMYK
    under no Adobe marker or transform 0, YCCK under any other transform;
  - `jdcolor.c`'s YCbCr -> RGB tables (16-bit fixed point); RGB planes
    copied through; YCCK -> CMYK as `ycck_cmyk_convert` (C, M, Y = 255 -
    the YCbCr -> RGB result, K copied); then OpenCV's CMYK -> BGR
    (`icvCvt_CMYK2BGR_8u_C4C3R`: X' = K - ((255 - X) * K >> 8)), since
    cv2 asks libjpeg for CMYK and converts it itself.

Gray images decode to (H, W) uint8, colour ones (RGB, YCbCr, CMYK, YCCK)
to (H, W, 3) uint8 RGB, as cv2 gives them. Arithmetic-coded, lossless,
hierarchical and 12-bit JPEGs raise ValueError naming their kind: no
encoder at hand (cv2, Pillow) writes one to test against.

Everything after the entropy decoding runs over all blocks at once. The
Huffman decoding is the one sequential loop: each table's symbol, run,
value and length are looked up in numpy for every bit position of the
scan at once (a 16-bit peek into a 65,536-entry table), so the loop only
follows them.
"""

from typing import Dict, List, Tuple

import numpy as np

# jpeg_natural_order: the zigzag index -> the natural (row-major) index,
# with libjpeg's 16 guard entries for a run that overshoots the block.
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

# A symbol that ends the block: an EOB (EOBn in a progressive scan).
_EOB = 64

_SOF_PROGRESSIVE = 0xC2
_SOF_UNSUPPORTED = {
    0xC3: 'lossless', 0xC5: 'hierarchical', 0xC6: 'hierarchical',
    0xC7: 'hierarchical', 0xC9: 'arithmetic-coded', 0xCA: 'arithmetic-coded',
    0xCB: 'arithmetic-coded', 0xCD: 'arithmetic-coded',
    0xCE: 'arithmetic-coded', 0xCF: 'arithmetic-coded'}


class _Component:
  __slots__ = ('cid', 'h', 'v', 'tq', 'quant', 'offset', 'bw', 'bh',
               'width', 'height')

  def __init__(self, cid, h, v, tq):
    self.cid, self.h, self.v, self.tq = cid, h, v, tq
    self.quant = None


def is_jpeg(data: bytes) -> bool:
  return data[:2] == b'\xff\xd8'


# ------------------------------------------------------------- Huffman

def _huffman_lut(counts: List[int], symbols: bytes):
  """A 16-bit peek -> (code length, symbol) table; length 0 is no code."""
  lengths = np.zeros(1 << 16, np.int64)
  values = np.zeros(1 << 16, np.int64)
  code = 0
  k = 0
  for length in range(1, 17):
    for _ in range(counts[length - 1]):
      if k >= len(symbols) or code >= (1 << length):
        raise ValueError('corrupt JPEG: bad Huffman table')
      lo = code << (16 - length)
      hi = (code + 1) << (16 - length)
      lengths[lo:hi] = length
      values[lo:hi] = symbols[k]
      code += 1
      k += 1
    code <<= 1
  return lengths, values


def _symbol_tables(lut, ac: bool, eob_runs: bool):
  """Per 16-bit peek: the bits a symbol takes with the bits after it, the
  mask of those bits, what to add to them, the bound under which HUFF_EXTEND
  makes them negative, and the run (`_EOB` for an EOB)."""
  length, symbol = lut
  if ac:
    run = symbol >> 4
    size = symbol & 15
    eob = (size == 0) & (run != 15)
    extra = np.where(eob, run if eob_runs else 0, size)
    base = np.where(eob & eob_runs, np.left_shift(1, run), 0)
    run = np.where(eob, _EOB, run)
  else:
    run = None
    size = extra = np.minimum(symbol, 16)
    base = np.zeros_like(size)
  half = np.where(size > 0, np.left_shift(1, np.maximum(size - 1, 0)), 0)
  total = np.where(length == 0, 0, length + extra)
  # No code at this peek: a step past any scan's end, reported as corrupt.
  taken = np.where(length == 0, 255, total).astype(np.uint8)
  mask = np.left_shift(1, extra) - 1
  return (40 - total, mask, base, half, taken,
          None if run is None else run.astype(np.uint8))


class _Bits:
  """A scan's unstuffed data: 64 bits from each byte on, and each bit."""

  def __init__(self, data: bytes):
    self.nbits = 8 * len(data)
    padded = np.frombuffer(data + bytes(16), np.uint8)
    b = padded.astype(np.uint64)
    n = len(data) + 8
    window = np.zeros(n, np.uint64)
    for i in range(8):  # big-endian
      window |= b[i:i + n] << np.uint64(56 - 8 * i)
    self.window = window
    self.bit = memoryview(np.unpackbits(padded))


# Bit positions decoded at once: bounds the temporaries.
_CHUNK = 1 << 20


def _decode_tables(bits: _Bits, tables: list) -> list:
  """Every bit position's symbol decoded with each table, as three
  memoryviews a table: the bits it takes (its code and the bits after it),
  its run (AC only; `_EOB` for an EOB) and its value (a DC difference, an
  AC coefficient, or the run of an EOBn in a progressive scan)."""
  out = [(np.empty(bits.nbits, np.uint8),
          None if t[5] is None else np.empty(bits.nbits, np.uint8),
          np.empty(bits.nbits, np.int16)) for t in tables]
  for lo in range(0, bits.nbits, _CHUNK):
    pos = np.arange(lo, min(lo + _CHUNK, bits.nbits), dtype=np.int64)
    hi = lo + len(pos)
    # The 40 bits from each position: a code (<= 16 bits) and the bits
    # after it (<= 16).
    head = ((bits.window[pos >> 3] << (pos & 7).astype(np.uint64))
            >> np.uint64(24)).astype(np.int64)
    peek = head >> 24
    for (shift_t, mask_t, base_t, half_t, taken_t, run_t), (
        taken, run, value) in zip(tables, out):
      mask = mask_t[peek]
      field = (head >> shift_t[peek]) & mask
      value[lo:hi] = field + base_t[peek] - np.where(
          field < half_t[peek], mask, 0)
      taken[lo:hi] = taken_t[peek]
      if run is not None:
        run[lo:hi] = run_t[peek]
  return [tuple(None if a is None else memoryview(a) for a in views)
          for views in out]


# ------------------------------------------------------------- parsing

def _segments(data: bytes, start: int) -> Tuple[bytes, List[int], int]:
  """The entropy-coded data of a scan from `start`: the bytes unstuffed,
  the byte offset of each restart interval in them, and the offset of the
  marker that ends the scan."""
  arr = np.frombuffer(data, np.uint8)
  ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
  nxt = arr[ff + 1]
  # FF 00 is a stuffed FF, FF FF is fill, FF D0-D7 a restart marker.
  ends = ff[(nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
  if not len(ends):
    raise ValueError('truncated JPEG: a scan runs to the end of the data')
  end = int(ends[0])
  chunks, offsets = [], [0]
  size = 0
  piece_start = start
  inside = ff[ff < end]
  skip = -1
  for i in inside.tolist():
    if i <= skip:
      continue
    marker = data[i + 1]
    if marker == 0x00:
      chunks.append(data[piece_start:i + 1])
      size += i + 1 - piece_start
      piece_start = i + 2
      skip = i + 1
    elif 0xD0 <= marker <= 0xD7:
      chunks.append(data[piece_start:i])
      size += i - piece_start
      offsets.append(size)
      piece_start = i + 2
      skip = i + 1
    else:  # fill byte before a marker: dropped
      chunks.append(data[piece_start:i])
      size += i - piece_start
      piece_start = i + 1
  chunks.append(data[piece_start:end])
  return b''.join(chunks), offsets, end


class _Frame:
  """The parsed frame: components, tables and coefficient storage."""

  def __init__(self):
    self.progressive = False
    self.components: List[_Component] = []
    self.quant: Dict[int, np.ndarray] = {}
    self.dc_luts = {}
    self.ac_luts = {}
    self.restart = 0
    self.width = self.height = 0
    self.jfif = False
    self.adobe_transform = None
    # Set by the frame header: the largest sampling factors, the MCUs a
    # row and column, and every component's coefficients (int32, natural
    # order, 64 a block) with a memoryview that the scans write through.
    self.hmax = self.vmax = self.mcux = self.mcuy = 0
    self.coefs = self.coef_view = None


def _parse_sof(frame: _Frame, body: bytes, marker: int):
  if marker in _SOF_UNSUPPORTED:
    raise ValueError(f'{_SOF_UNSUPPORTED[marker]} JPEGs are not supported')
  precision = body[0]
  if precision != 8:
    raise ValueError(f'{precision}-bit JPEGs are not supported (8-bit only)')
  frame.progressive = marker == _SOF_PROGRESSIVE
  frame.height = int.from_bytes(body[1:3], 'big')
  frame.width = int.from_bytes(body[3:5], 'big')
  if frame.width == 0 or frame.height == 0:
    raise ValueError('JPEGs with no size in the frame header are not '
                     'supported')
  count = body[5]
  for i in range(count):
    cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
    h, v = hv >> 4, hv & 15
    if not (1 <= h <= 4 and 1 <= v <= 4):
      raise ValueError('corrupt JPEG: bad sampling factors')
    frame.components.append(_Component(cid, h, v, tq))
  hmax = max(c.h for c in frame.components)
  vmax = max(c.v for c in frame.components)
  frame.hmax, frame.vmax = hmax, vmax
  frame.mcux = -(-frame.width // (8 * hmax))
  frame.mcuy = -(-frame.height // (8 * vmax))
  offset = 0
  for c in frame.components:
    c.width = -(-frame.width * c.h // hmax)   # downsampled_width
    c.height = -(-frame.height * c.v // vmax)
    c.bw = frame.mcux * c.h
    c.bh = frame.mcuy * c.v
    c.offset = offset
    offset += c.bw * c.bh * 64
  frame.coefs = np.zeros(offset, np.int32)
  frame.coef_view = memoryview(frame.coefs)


def _parse_dqt(frame: _Frame, body: bytes):
  i = 0
  while i < len(body):
    pq, tq = body[i] >> 4, body[i] & 15
    i += 1
    n = 128 if pq else 64
    raw = np.frombuffer(body[i:i + n], '>u2' if pq else np.uint8)
    table = np.zeros(64, np.int64)
    table[_NATURAL[:64]] = raw
    frame.quant[tq] = table
    i += n


def _parse_dht(frame: _Frame, body: bytes):
  i = 0
  while i < len(body):
    tc, th = body[i] >> 4, body[i] & 15
    counts = list(body[i + 1:i + 17])
    total = sum(counts)
    symbols = body[i + 17:i + 17 + total]
    (frame.ac_luts if tc else frame.dc_luts)[th] = _huffman_lut(
        counts, symbols)
    i += 17 + total


# ------------------------------------------------------------- scans

def _scan_blocks(frame: _Frame, comps: List[_Component]):
  """The base offset (in `frame.coefs`) and the scan's component index of
  each block, in decoding order, and the blocks of one MCU."""
  if len(comps) == 1:
    c = comps[0]
    rows, cols = -(-c.height // 8), -(-c.width // 8)
    r, q = np.meshgrid(np.arange(rows), np.arange(cols), indexing='ij')
    bases = c.offset + (r.ravel() * c.bw + q.ravel()) * 64
    return bases, np.zeros(len(bases), np.int64), 1
  my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux),
                       indexing='ij')
  my, mx = my.ravel()[:, None], mx.ravel()[:, None]
  parts, which = [], []
  for i, c in enumerate(comps):
    by, bx = np.meshgrid(np.arange(c.v), np.arange(c.h), indexing='ij')
    row = my * c.v + by.ravel()[None]
    col = mx * c.h + bx.ravel()[None]
    parts.append(c.offset + (row * c.bw + col) * 64)
    which.append(np.full(parts[-1].shape, i))
  bases = np.concatenate(parts, axis=1)
  return bases.ravel(), np.concatenate(which, axis=1).ravel(), bases.shape[1]


def _decode_scan(frame: _Frame, data: bytes, start: int) -> int:
  """Decodes the scan whose header (from its length field) starts at
  `start`; returns the offset of the marker after its data."""
  length = int.from_bytes(data[start:start + 2], 'big')
  header = data[start + 2:start + length]
  count = header[0]
  by_id = {c.cid: c for c in frame.components}
  comps, dc_tables, ac_tables = [], [], []
  for i in range(count):
    cid, tables = header[1 + 2 * i], header[2 + 2 * i]
    if cid not in by_id:
      raise ValueError('corrupt JPEG: a scan names an unknown component')
    comps.append(by_id[cid])
    dc_tables.append(tables >> 4)
    ac_tables.append(tables & 15)
  ss, se, a = header[1 + 2 * count:4 + 2 * count]
  ah, al = a >> 4, a & 15
  if not frame.progressive:
    ss, se, ah, al = 0, 63, 0, 0
  elif (ss == 0) != (se == 0) or se > 63 or ss > se or (
      ss > 0 and count != 1):
    raise ValueError('corrupt JPEG: bad progression parameters')
  for c in comps:  # libjpeg latches each quant table at its first scan
    if c.quant is None:
      if c.tq not in frame.quant:
        raise ValueError('corrupt JPEG: a missing quantisation table')
      c.quant = frame.quant[c.tq]

  payload, offsets, end = _segments(data, start + length)
  bits = _Bits(payload)
  need_dc = ss == 0 and ah == 0
  need_ac = ss > 0 or not frame.progressive
  keys = sorted({(False, t) for t in dc_tables if need_dc}
                | {(True, t) for t in ac_tables if need_ac})
  for kind, t in keys:
    if t not in (frame.ac_luts if kind else frame.dc_luts):
      raise ValueError('corrupt JPEG: a missing Huffman table')
  views = dict(zip(keys, _decode_tables(bits, [
      _symbol_tables((frame.ac_luts if kind else frame.dc_luts)[t], kind,
                     frame.progressive) for kind, t in keys])))
  dc = [views[False, t] if need_dc else None for t in dc_tables]
  ac = [views[True, t] if need_ac else None for t in ac_tables]

  bases, which, per_mcu = _scan_blocks(frame, comps)
  mcus = len(bases) // per_mcu
  interval = frame.restart or mcus
  if len(offsets) < -(-mcus // interval):
    raise ValueError('truncated JPEG: restart markers are missing')
  bases, which = bases.tolist(), which.tolist()
  for seg in range(-(-mcus // interval)):
    lo = seg * interval * per_mcu
    hi = min(mcus, (seg + 1) * interval) * per_mcu
    p = 8 * offsets[seg]
    limit = 8 * offsets[seg + 1] if seg + 1 < len(offsets) else bits.nbits
    # A restart interval starts with no DC prediction and no EOB run.
    preds = [0] * len(comps)
    try:
      if not frame.progressive:
        p = _baseline(frame.coef_view, bits, dc, ac, bases[lo:hi],
                      which[lo:hi], preds, p)
      elif ss == 0 and ah == 0:
        p = _dc_first(frame.coef_view, dc, bases[lo:hi], which[lo:hi],
                      preds, al, p)
      elif ss == 0:
        p = _dc_refine(frame.coef_view, bits, bases[lo:hi], al, p)
      elif ah == 0:
        p = _ac_first(frame.coef_view, ac[0], bases[lo:hi], ss, se, al, p)
      else:
        p = _ac_refine(frame.coef_view, bits, ac[0], bases[lo:hi], ss, se,
                       al, p)
    except IndexError:
      p = 1 << 62
    if p > limit:
      raise ValueError('corrupt or truncated JPEG: a scan ran past its data')
  return end


def _baseline(coef, bits, dc, ac, bases, which, preds, p):
  nat = _NATURAL
  for base, ci in zip(bases, which):
    dct, _, dcv = dc[ci]
    act, acr, acv = ac[ci]
    preds[ci] += dcv[p]
    p += dct[p]
    coef[base] = preds[ci]
    k = 1
    while k < 64:
      r = acr[p]
      v = acv[p]
      p += act[p]
      if r == _EOB:
        break
      k += r
      if v:
        coef[base + nat[k]] = v
      k += 1
  return p


def _dc_first(coef, dc, bases, which, preds, al, p):
  for base, ci in zip(bases, which):
    dct, _, dcv = dc[ci]
    preds[ci] += dcv[p]
    p += dct[p]
    coef[base] = preds[ci] << al
  return p


def _dc_refine(coef, bits, bases, al, p):
  bit = bits.bit
  p1 = 1 << al
  for base in bases:
    if bit[p]:
      coef[base] |= p1
    p += 1
  return p


def _ac_first(coef, ac, bases, ss, se, al, p):
  act, acr, acv = ac
  nat = _NATURAL
  run = 0  # blocks left in the current EOB run
  for base in bases:
    if run:
      run -= 1
      continue
    k = ss
    while k <= se:
      r = acr[p]
      v = acv[p]
      p += act[p]
      if r == _EOB:
        run = v - 1
        break
      k += r
      if v:
        coef[base + nat[k]] = v << al
      k += 1
  return p


def _ac_refine(coef, bits, ac, bases, ss, se, al, p):
  act, acr, acv = ac
  bit = bits.bit
  nat = _NATURAL
  p1 = 1 << al
  m1 = -1 << al
  run = 0  # blocks left in the current EOB run
  for base in bases:
    k = ss
    if run == 0:
      while k <= se:
        r = acr[p]
        v = acv[p]
        p += act[p]
        if r == _EOB:
          run = v
          break
        # v: +-1 for a newly nonzero coefficient, 0 for a ZRL.
        while k <= se:
          idx = base + nat[k]
          c = coef[idx]
          if c:
            if bit[p] and not c & p1:
              coef[idx] = c + (p1 if c >= 0 else m1)
            p += 1
          else:
            if r == 0:
              break
            r -= 1
          k += 1
        if v:
          coef[base + nat[k]] = p1 if v > 0 else m1
        k += 1
    if run > 0:
      while k <= se:
        idx = base + nat[k]
        c = coef[idx]
        if c:
          if bit[p] and not c & p1:
            coef[idx] = c + (p1 if c >= 0 else m1)
          p += 1
        k += 1
      run -= 1
  return p


# ------------------------------------------------------------- pixels

# jidctint.c's constants, FIX(x) at CONST_BITS = 13.
_CONST_BITS = 13
_PASS1_BITS = 2
_F0_298 = 2446
_F0_390 = 3196
_F0_541 = 4433
_F0_765 = 6270
_F0_899 = 7373
_F1_175 = 9633
_F1_501 = 12299
_F1_847 = 15137
_F1_961 = 16069
_F2_053 = 16819
_F2_562 = 20995
_F3_072 = 25172


def _idct_1d(x: List[np.ndarray], descale: int) -> List[np.ndarray]:
  """One pass of jpeg_idct_islow over the 8 inputs x[0..7] (int64 arrays),
  descaled by `descale` bits with rounding."""
  z2, z3 = x[2], x[6]
  z1 = (z2 + z3) * _F0_541
  tmp2 = z1 - z3 * _F1_847
  tmp3 = z1 + z2 * _F0_765
  tmp0 = (x[0] + x[4]) << _CONST_BITS
  tmp1 = (x[0] - x[4]) << _CONST_BITS
  tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
  tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

  t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
  z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
  z5 = (z3 + z4) * _F1_175
  t0 = t0 * _F0_298
  t1 = t1 * _F2_053
  t2 = t2 * _F3_072
  t3 = t3 * _F1_501
  z1 = z1 * -_F0_899
  z2 = z2 * -_F2_562
  z3 = z3 * -_F1_961 + z5
  z4 = z4 * -_F0_390 + z5
  t0 = t0 + z1 + z3
  t1 = t1 + z2 + z4
  t2 = t2 + z2 + z3
  t3 = t3 + z1 + z4

  half = 1 << (descale - 1)
  out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
  return [(o + half) >> descale for o in out]


def _idct(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
  """Dequantises and inverse-transforms (n, 64) coefficient blocks to
  (n, 8, 8) uint8 samples."""
  coef = (blocks.astype(np.int64) * quant).reshape(-1, 8, 8)
  cols = _idct_1d([coef[:, i, :] for i in range(8)],
                  _CONST_BITS - _PASS1_BITS)
  work = np.stack(cols, axis=1)  # (n, row, col)
  rows = _idct_1d([work[:, :, j] for j in range(8)],
                  _CONST_BITS + _PASS1_BITS + 3)
  out = np.stack(rows, axis=2)
  # range_limit[x & RANGE_MASK] of the IDCT: x + 128 clamped to [0, 255]
  # for x in [-512, 511], wrapping around outside that.
  wrapped = ((out + 512) & 1023) - 512
  return np.clip(wrapped + 128, 0, 255).astype(np.uint8)


def _fancy_h(plane: np.ndarray, bias_even: int, bias_odd: int,
             shift: int, weight: int) -> np.ndarray:
  """Horizontal triangle upsampling by 2: 3 * near + far."""
  left = np.concatenate([plane[:, :1], plane[:, :-1]], axis=1)
  right = np.concatenate([plane[:, 1:], plane[:, -1:]], axis=1)
  out = np.empty((plane.shape[0], 2 * plane.shape[1]), np.int32)
  out[:, 0::2] = (plane * 3 + left + bias_even) >> shift
  out[:, 1::2] = (plane * 3 + right + bias_odd) >> shift
  return out


def _fancy_v(plane: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """Vertical sums for output rows 2i (row above) and 2i+1 (row below)."""
  above = np.concatenate([plane[:1], plane[:-1]], axis=0)
  below = np.concatenate([plane[1:], plane[-1:]], axis=0)
  return plane * 3 + above, plane * 3 + below


def _upsample(plane: np.ndarray, c: _Component, frame: _Frame) -> np.ndarray:
  """The component (its downsampled size) at the full size, cropped."""
  rh, rv = frame.hmax // c.h, frame.vmax // c.v
  if frame.hmax % c.h or frame.vmax % c.v:
    raise ValueError('JPEGs with fractional sampling ratios are not '
                     'supported')
  x = plane.astype(np.int32)
  if (rh, rv) == (1, 1):
    out = x
  elif (rh, rv) == (2, 1) and c.width > 2:
    out = _fancy_h(x, 1, 2, 2, 3)
  elif (rh, rv) == (1, 2):
    upper, lower = _fancy_v(x)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (upper + 1) >> 2
    out[1::2] = (lower + 2) >> 2
  elif (rh, rv) == (2, 2) and c.width > 2:
    upper, lower = _fancy_v(x)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    out[0::2] = _fancy_h(upper, 8, 7, 4, 3)
    out[1::2] = _fancy_h(lower, 8, 7, 4, 3)
  else:
    out = np.repeat(np.repeat(x, rv, axis=0), rh, axis=1)
  return out[:frame.height, :frame.width]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
  """jdcolor.c's ycc_rgb_convert (SCALEBITS 16)."""
  x = np.arange(256, dtype=np.int64) - 128
  half = 1 << 15
  cr_r = (91881 * x + half) >> 16      # FIX(1.40200)
  cb_b = (116130 * x + half) >> 16     # FIX(1.77200)
  cr_g = -46802 * x                    # FIX(0.71414)
  cb_g = -22554 * x + half             # FIX(0.34414)
  r = y + cr_r[cr]
  g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
  b = y + cb_b[cb]
  return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _pixels(frame: _Frame, space: str) -> np.ndarray:
  planes = []
  for c in frame.components:
    if c.quant is None:
      raise ValueError('truncated JPEG: a component has no scan')
    blocks = frame.coefs[c.offset:c.offset + c.bw * c.bh * 64]
    samples = _idct(blocks.reshape(-1, 64), c.quant)
    samples = samples.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
    plane = samples.reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width]
    planes.append(_upsample(plane, c, frame).astype(np.int64))
  if space == 'gray':
    return planes[0].astype(np.uint8)
  if space == 'rgb':
    return np.stack(planes, axis=-1).astype(np.uint8)
  if space == 'ycc':
    return _ycc_to_rgb(*planes)
  if space == 'ycck':
    # jdcolor.c's ycck_cmyk_convert: C, M, Y = 255 - the YCbCr -> RGB
    # result, K copied.
    cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int64)
    planes = [cmy[..., 0], cmy[..., 1], cmy[..., 2], planes[3]]
  return _cmyk_to_rgb(*planes)


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
  """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on libjpeg's JCS_CMYK output, in
  RGB order: X' = K - ((255 - X) * K >> 8) for X in C, M, Y."""
  return np.stack([k - (((255 - x) * k) >> 8) for x in (c, m, y)],
                  axis=-1).astype(np.uint8)


def _color_space(frame: _Frame) -> str:
  """libjpeg's default_decompress_parms (jdapimin.c): the colour space of
  a frame of 1, 3 or 4 components."""
  n = len(frame.components)
  if n == 1:
    return 'gray'
  if n == 3:
    if frame.jfif:
      return 'ycc'
    if frame.adobe_transform is not None:
      return 'rgb' if frame.adobe_transform == 0 else 'ycc'
    ids = [c.cid for c in frame.components]
    return 'rgb' if ids == [82, 71, 66] else 'ycc'
  if n == 4:
    if frame.adobe_transform is not None and frame.adobe_transform != 0:
      return 'ycck'
    return 'cmyk'
  raise ValueError(f'{n}-component JPEGs are not supported (libjpeg has no '
                   'colour conversion for them)')


def decode_jpeg(data: bytes) -> np.ndarray:
  """Decodes a JPEG as cv2.imdecode(IMREAD_UNCHANGED) does, but RGB:
  (H, W) uint8 for gray, (H, W, 3) uint8 for colour."""
  if not is_jpeg(data):
    raise ValueError('not a JPEG: no SOI marker')
  frame = _Frame()
  i = 2
  seen_frame = False
  space = None
  while True:
    # Markers may be preceded by any number of FF fill bytes.
    while i < len(data) and data[i] == 0xFF and i + 1 < len(data) and (
        data[i + 1] == 0xFF):
      i += 1
    if i + 1 >= len(data):
      raise ValueError('truncated JPEG: no EOI marker')
    if data[i] != 0xFF:
      raise ValueError(f'corrupt JPEG: no marker at byte {i}')
    marker = data[i + 1]
    i += 2
    if marker == 0xD9:  # EOI
      break
    if 0xD0 <= marker <= 0xD8 or marker == 0x01:
      continue
    if i + 2 > len(data):
      raise ValueError('truncated JPEG: a marker segment is cut')
    length = int.from_bytes(data[i:i + 2], 'big')
    if length < 2 or i + length > len(data):
      raise ValueError('truncated JPEG: a marker segment is cut')
    body = data[i + 2:i + length]
    if marker == 0xDA:  # SOS
      if not seen_frame:
        raise ValueError('corrupt JPEG: a scan before the frame header')
      # libjpeg settles the colour space when it reaches the first scan.
      if space is None:
        space = _color_space(frame)
      i = _decode_scan(frame, data, i)
      continue
    if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
      if seen_frame:
        raise ValueError('corrupt JPEG: two frame headers')
      _parse_sof(frame, body, marker)
      seen_frame = True
    elif marker == 0xCC:
      raise ValueError('arithmetic-coded JPEGs are not supported')
    elif marker == 0xC4:
      _parse_dht(frame, body)
    elif marker == 0xDB:
      _parse_dqt(frame, body)
    elif marker == 0xDD:
      frame.restart = int.from_bytes(body[:2], 'big')
    elif marker == 0xE0 and body[:5] == b'JFIF\x00':
      frame.jfif = True
    elif marker == 0xEE and body[:5] == b'Adobe' and len(body) >= 12:
      frame.adobe_transform = body[11]
    i += length
  if not seen_frame:
    raise ValueError('corrupt JPEG: no frame header')
  return _pixels(frame, space or _color_space(frame))
