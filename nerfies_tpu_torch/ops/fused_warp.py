"""The warp trunk of training: primal and Jacobian tangents, fused.

Port of nerfies_tpu/ops/fused_warp.py: `_warp_fwd` (:147) and `_warp_bwd`
(:207), the forward and the custom VJP of `warp_mlp_train`. The warp
trunk and its linear head run over the primal encoding and 0 or 3 tangent
encodings (the columns d pe / d x_j); the tangent chains take the same
weight products without bias and the primal's ReLU mask, so their head
outputs are the directional derivatives of the warp. The per-ray metadata
embedding enters as an (N, F) operand at layer 0 and at each skip (the
SplitDense rows [prev | pe | embed]).

On a CUDA tensor `warp_mlp_forward` and `warp_mlp_backward` launch the
hand-written kernels of csrc/fused_warp.cu and of csrc/fused_warp_bwd.cu
with csrc/weight_grad.cu, and count their launches; on a CPU tensor they run
the plain versions, which keep the kernels' rounding points: bf16
operands, f32 sums with the bias added in f32, the forward's mask from the
primal's f32 pre-activation and the backward's from its bf16 activation
(as the two Pallas kernels do), f32 head outputs, input cotangents and dW.
Neither falls back to the other.

The elastic loss differentiates through the Jacobian, so the backward is
exact through the tangent chains: given the masks, each chain is linear
in its input and in the weights, and the masks' own derivative is zero.

`warp_mlp_train` is the autograd Function. Its backward computes dx and
d_tangents only when autograd asks for them (`ctx.needs_input_grad`);
the param gradients are the same either way. On the training path no
warp input needs them: the coarse and fine sample points and the
background points carry no parameter dependence, so the port skips the
(N, C) cotangents that the JAX fine level computes.
"""

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from nerfies_tpu_torch import utils
from nerfies_tpu_torch.ops import _build
from nerfies_tpu_torch.ops import fused_mlp
from nerfies_tpu_torch.ops.fused_mlp import (_HEAD_PAD, _MAX_DEPTH, _OUT_COLS,
                                             _PE_PAD, _bf16, _check_launch,
                                             _check_operands, _dot,
                                             _pad_cols, _pad_rows,
                                             _pointer_array, _workspace)

_WIDTHS = (128,)
_TANGENTS = (0, 3)
# Workspace bytes per chunk of the backward: 131,072 rows with 3 tangents
# at the bench widths (12,960 bytes a row), 1.7 GB.
_WARP_BWD_BUDGET = 131072 * 12960
# Rows per block of the backward's row pass (csrc/fused_warp_bwd.cu), all
# chains stacked.
_WARP_BWD_TILE = 128


def bwd_tile_rows(nt: int) -> int:
  """Rows of each chain that one block of the backward's row pass owns."""
  return _WARP_BWD_TILE // (nt + 1)


def bwd_workspace_row_bytes(nt: int, width: int, depth: int) -> int:
  """Workspace bytes per row of the backward with nt tangents: every
  chain's input and head cotangents and its activation and pre-activation
  cotangent per layer, and the primal's embedding, all bf16."""
  chains = nt + 1
  return 2 * (chains * (_PE_PAD + _HEAD_PAD + 2 * depth * width) + _HEAD_PAD)


def bwd_chunk_rows(nt: int, width: int, depth: int) -> int:
  """Most rows per chunk of the backward whose workspace fits in
  _WARP_BWD_BUDGET bytes: a multiple of the row pass's rows per chain and
  block."""
  tile = bwd_tile_rows(nt)
  row_bytes = bwd_workspace_row_bytes(nt, width, depth)
  return max(tile, _WARP_BWD_BUDGET // row_bytes // tile * tile)


def bwd_chunks(n: int, most: int):
  """[(row0, rows)]: n rows in the fewest chunks of at most `most` rows,
  of equal size but for the last."""
  count = -(-n // most)
  size = -(-n // count)
  return [(row0, min(size, n - row0)) for row0 in range(0, n, size)]


@utils.spanned('kernel.pack')
def pack(params: dict, c_in: int, f_embed: int, trunk_depth: int,
         skips: Sequence[int]) -> Dict[str, torch.Tensor]:
  """Warp trunk and head params -> {name: bf16 operand} (fused_warp.py:44).

  `params` = {'trunk': {'hidden_i': {kernel, bias}}, 'head': {'logit':
  {kernel, bias}}}, SplitDense rows [prev | pe | embed] (layer 0: [pe |
  embed]). Names: w0, we0; skip layers w{i}, wx{i}, we{i}; others w{i};
  b{i}; the head wh, bh, padded to 8 columns.
  """
  trunk = params['trunk']
  width = trunk['hidden_0']['kernel'].shape[1]
  head = params['head']['logit']
  ops = {}
  for i in range(trunk_depth):
    k = trunk[f'hidden_{i}']['kernel']
    if i == 0:
      ops['w0'] = _bf16(k[:c_in])
      ops['we0'] = _bf16(k[c_in:c_in + f_embed])
    elif i in skips:
      ops[f'w{i}'] = _bf16(k[:width])
      ops[f'wx{i}'] = _bf16(k[width:width + c_in])
      ops[f'we{i}'] = _bf16(k[width + c_in:width + c_in + f_embed])
    else:
      ops[f'w{i}'] = _bf16(k)
    ops[f'b{i}'] = _bf16(trunk[f'hidden_{i}']['bias'])
  ops['wh'] = _bf16(_pad_cols(head['kernel'], _OUT_COLS))
  ops['bh'] = _bf16(_pad_cols(head['bias'], _OUT_COLS))
  return ops


def _is_skip(i, skips):
  return i != 0 and i in skips


# --------------------------------------------------------- plain versions

def _plain_fwd(x, e, tangents, ops, trunk_depth, skips, save=False):
  """Primal and tangent chains (fused_warp.py:90 _fwd_tile)."""
  xt, et = x.to(torch.bfloat16), e.to(torch.bfloat16)
  tts = [t.to(torch.bfloat16) for t in tangents]
  acts = {}
  h, ths = None, [None] * len(tts)
  for i in range(trunk_depth):
    if i == 0:
      acc = _dot(xt, ops['w0']) + _dot(et, ops['we0'])
      taccs = [_dot(t, ops['w0']) for t in tts]
    elif _is_skip(i, skips):
      acc = (_dot(h, ops[f'w{i}']) + _dot(xt, ops[f'wx{i}'])
             + _dot(et, ops[f'we{i}']))
      taccs = [_dot(ths[j], ops[f'w{i}']) + _dot(tts[j], ops[f'wx{i}'])
               for j in range(len(tts))]
    else:
      acc = _dot(h, ops[f'w{i}'])
      taccs = [_dot(ths[j], ops[f'w{i}']) for j in range(len(tts))]
    acc = acc + ops[f'b{i}'].float()
    mask = acc > 0.0
    h = torch.where(mask, acc, torch.zeros_like(acc)).to(torch.bfloat16)
    ths = [(t * mask).to(torch.bfloat16) for t in taccs]
    if save:
      acts[f'h{i}'] = h
      for j, t in enumerate(ths):
        acts[f't{j}h{i}'] = t
  out = _dot(h, ops['wh']) + ops['bh'].float()
  jouts = [_dot(t, ops['wh']) for t in ths]
  return out, jouts, (xt, et, tts, acts)


def _plain_bwd(x, e, tangents, g_out, g_jouts, ops, trunk_depth, skips,
               need_dx):
  """The VJP (fused_warp.py:237): (d_embed, dx, d_tangents, {name: dW})."""
  _, _, (xt, et, tts, acts) = _plain_fwd(x, e, tangents, ops, trunk_depth,
                                         skips, save=True)
  nt = len(tts)
  go = g_out.to(torch.bfloat16)
  gjs = [g.to(torch.bfloat16) for g in g_jouts]
  dws = {}
  last = trunk_depth - 1
  dwh = _dot(acts[f'h{last}'].t(), go)
  for j in range(nt):
    dwh = dwh + _dot(acts[f't{j}h{last}'].t(), gjs[j])
  dws['wh'] = dwh
  dws['bh'] = go.float().sum(0)
  g_h = _dot(go, ops['wh'].t()).to(torch.bfloat16)
  g_ts = [_dot(g, ops['wh'].t()).to(torch.bfloat16) for g in gjs]
  n = x.shape[0]
  g_e = torch.zeros((n, e.shape[1]), dtype=torch.float32, device=x.device)
  g_x = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
  g_txs = [torch.zeros_like(g_x) for _ in range(nt)]
  for i in range(trunk_depth - 1, -1, -1):
    mask = acts[f'h{i}'].float() > 0.0
    g_pre = (g_h.float() * mask).to(torch.bfloat16)
    g_tpres = [(g_ts[j].float() * mask).to(torch.bfloat16)
               for j in range(nt)]
    src = xt if i == 0 else acts[f'h{i - 1}']
    dw = _dot(src.t(), g_pre)
    for j in range(nt):
      tsrc = tts[j] if i == 0 else acts[f't{j}h{i - 1}']
      dw = dw + _dot(tsrc.t(), g_tpres[j])
    dws[f'w{i}'] = dw
    dws[f'b{i}'] = g_pre.float().sum(0)
    if _is_skip(i, skips):
      dwx = _dot(xt.t(), g_pre)
      for j in range(nt):
        dwx = dwx + _dot(tts[j].t(), g_tpres[j])
      dws[f'wx{i}'] = dwx
      dws[f'we{i}'] = _dot(et.t(), g_pre)
      g_e = g_e + _dot(g_pre, ops[f'we{i}'].t())
      if need_dx:
        g_x = g_x + _dot(g_pre, ops[f'wx{i}'].t())
        for j in range(nt):
          g_txs[j] = g_txs[j] + _dot(g_tpres[j], ops[f'wx{i}'].t())
    if i == 0:
      dws['we0'] = _dot(et.t(), g_pre)
      g_e = g_e + _dot(g_pre, ops['we0'].t())
      if need_dx:
        g_x = g_x + _dot(g_pre, ops['w0'].t())
        for j in range(nt):
          g_txs[j] = g_txs[j] + _dot(g_tpres[j], ops['w0'].t())
    else:
      g_h = _dot(g_pre, ops[f'w{i}'].t()).to(torch.bfloat16)
      g_ts = [_dot(g_tpres[j], ops[f'w{i}'].t()).to(torch.bfloat16)
              for j in range(nt)]
  if not need_dx:
    return g_e, None, None, dws
  return g_e, g_x, g_txs, dws


def grads_to_tree(dws, params, trunk_depth, skips) -> dict:
  """Packed dW -> the param tree's shapes (fused_warp.py:369-392)."""
  d_trunk = {}
  for i in range(trunk_depth):
    if i == 0:
      kernel = torch.cat([dws['w0'], dws['we0']], 0)
    elif _is_skip(i, skips):
      kernel = torch.cat([dws[f'w{i}'], dws[f'wx{i}'], dws[f'we{i}']], 0)
    else:
      kernel = dws[f'w{i}']
    d_trunk[f'hidden_{i}'] = {'kernel': kernel, 'bias': dws[f'b{i}']}
  out_ch = params['head']['logit']['kernel'].shape[1]
  return {'trunk': d_trunk,
          'head': {'logit': {'kernel': dws['wh'][:, :out_ch],
                             'bias': dws['bh'][:out_ch]}}}


# ---------------------------------------------------------------- kernels

def _check_inputs(name, x, e, tangents, ops, trunk_depth):
  if x.dim() != 2 or x.shape[0] <= 0:
    raise ValueError(f'{name}: x must be (N, C) with N > 0, got '
                     f'{tuple(x.shape)}')
  n, c_in = x.shape
  width = ops['w0'].shape[1]
  if c_in > _PE_PAD or e.shape[1] > _HEAD_PAD:
    raise ValueError(f'{name}: the kernel takes at most {_PE_PAD} encoding '
                     f'and {_HEAD_PAD} embedding columns')
  if width not in _WIDTHS or len(tangents) not in _TANGENTS:
    raise ValueError(f'{name}: kernel built for widths {_WIDTHS} and '
                     f'{_TANGENTS} tangents, got {width}, {len(tangents)}')
  if not 1 <= trunk_depth <= _MAX_DEPTH:
    raise ValueError(f'{name}: trunk depth must be in [1, {_MAX_DEPTH}]')
  for t in (e, *tangents):
    if t.device != x.device or t.shape[0] != n:
      raise ValueError(f'{name}: inputs must share rows and device')
  for t in tangents:
    if tuple(t.shape) != (n, c_in):
      raise ValueError(f'{name}: tangents must be ({n}, {c_in})')


def _f32(t):
  return t.float().contiguous()


@utils.spanned('kernel.pack')
def _kernel_weights(ops, trunk_depth, skips):
  """w, wx, we, b (padded to the kernel's shapes), in pointer order."""
  pad = [None] * (_MAX_DEPTH - trunk_depth)
  w = ([_pad_rows(ops['w0'], _PE_PAD).contiguous()]
       + [ops[f'w{i}'] for i in range(1, trunk_depth)])
  wx = [(_pad_rows(ops[f'wx{i}'], _PE_PAD).contiguous()
         if _is_skip(i, skips) else None) for i in range(_MAX_DEPTH)]
  we = [(_pad_rows(ops[f'we{i}'], _HEAD_PAD).contiguous()
         if i == 0 or _is_skip(i, skips) else None)
        for i in range(_MAX_DEPTH)]
  b = [ops[f'b{i}'] for i in range(trunk_depth)]
  head = [_pad_cols(ops['wh'], _HEAD_PAD).contiguous(),
          _pad_cols(ops['bh'], _HEAD_PAD).contiguous()]
  return w + pad, wx, we, b + pad, head


def _launch_fwd(x, e, tangents, ops, trunk_depth, skips):
  name = 'warp_mlp_forward'
  _check_inputs(name, x, e, tangents, ops, trunk_depth)
  n, c_in = x.shape
  nt = len(tangents)
  w, wx, we, b, head = _kernel_weights(ops, trunk_depth, skips)
  _check_operands([t for t in w + wx + we + b + head if t is not None],
                  x.device, name)
  x, e = _f32(x), _f32(e)
  ts = [_f32(t) for t in tangents] + [None] * (3 - nt)
  out = torch.empty((n, _OUT_COLS), dtype=torch.float32, device=x.device)
  jouts = [torch.empty_like(out) for _ in range(nt)]
  ptrs = _pointer_array([x, e] + ts + [out] + jouts + [None] * (3 - nt)
                        + w + wx + we + b + head)
  lib = _build.load()
  rc = lib.warp_train_forward(
      ctypes.addressof(ptrs), n, c_in, e.shape[1], trunk_depth,
      sum(1 << i for i in range(trunk_depth) if _is_skip(i, skips)), nt,
      ops['w0'].shape[1], *_build.launch_target(x.device))
  _check_launch(lib, rc, name)
  warp_mlp_forward.launches += 1
  return out, jouts


def _bwd_passes(x, e, tangents, g_out, g_jouts, ops, trunk_depth, skips,
                need_dx, chunk=None):
  """The checks, outputs and workspace of one kernel backward.

  Chunks of at most `chunk` rows (by default as many as bwd_chunk_rows
  allows). Returns (passes, finish): one (row_pass, weight_pass) pair of
  callables per chunk, each launching its kernel on the current stream and
  to be called in order; finish() gives (d_embed, dx, d_tangents, {name:
  dW}) after all.
  """
  name = 'warp_mlp_backward'
  _check_inputs(name, x, e, tangents, ops, trunk_depth)
  n, c_in = x.shape
  f_embed = e.shape[1]
  nt = len(tangents)
  chains = nt + 1
  width = ops['w0'].shape[1]
  device = x.device
  for g in (g_out, *g_jouts):
    if g.device != device or tuple(g.shape) != (n, _OUT_COLS):
      raise ValueError(f'{name}: cotangents must be ({n}, {_OUT_COLS}) on '
                       f'{device}')
  # The kernel reads every weight in its (in, out) layout, also where it
  # multiplies by the transpose: no transposed copies.
  w, wx, we, b, head = _kernel_weights(ops, trunk_depth, skips)
  weights = w + wx + we + b + head[:1]
  _check_operands([t for t in weights if t is not None], device, name)
  x, e = _f32(x), _f32(e)
  ts = [_f32(t) for t in tangents] + [None] * (3 - nt)
  g_out = _f32(g_out)
  gjs = [_f32(g) for g in g_jouts] + [None] * (3 - nt)

  depth = trunk_depth
  tile = bwd_tile_rows(nt)
  chunks = bwd_chunks(n, chunk or bwd_chunk_rows(nt, width, depth))
  # Each chunk's row pass writes whole tiles: rows rounded up to the tile.
  rows_alloc = -(-chunks[0][1] // tile) * tile
  stacked = chains * rows_alloc
  shapes = ([(stacked, _PE_PAD), (rows_alloc, _HEAD_PAD)]
            + [(stacked, width)] * depth + [(stacked, _HEAD_PAD)]
            + [(stacked, width)] * depth)
  views = iter(_workspace(device, shapes))
  ws_in, ws_e = next(views), next(views)
  ws_h = [next(views) for _ in range(depth)]
  ws_gh = next(views)
  ws_gp = [next(views) for _ in range(depth)]

  grads = fused_mlp._WeightGrads()
  chained = set()  # jobs over every chain; the others see the primal only
  for i in range(depth):
    grads.add(f'w{i}', ws_in if i == 0 else ws_h[i - 1], ws_gp[i], f'b{i}')
    chained.add(f'w{i}')
    if _is_skip(i, skips):
      grads.add(f'wx{i}', ws_in, ws_gp[i])
      chained.add(f'wx{i}')
    if i == 0 or _is_skip(i, skips):
      grads.add(f'we{i}', ws_e, ws_gp[i])
  grads.add('wh', ws_h[-1], ws_gh, 'bh')
  chained.add('wh')
  partial = torch.empty(grads.splits(fused_mlp._sm_count(device))
                        * grads.size,
                        dtype=torch.float32, device=device)
  flat = torch.empty(grads.size, dtype=torch.float32, device=device)

  d_embed = torch.empty((n, f_embed), dtype=torch.float32, device=device)
  dx = dts = None
  if need_dx:
    dx = torch.empty((n, c_in), dtype=torch.float32, device=device)
    dts = [torch.empty_like(dx) for _ in range(nt)]
  pad = [None] * (_MAX_DEPTH - depth)
  ptrs = _pointer_array(
      [x, e] + ts + [g_out] + gjs + [d_embed, dx] + (dts or [])
      + [None] * (3 - len(dts or [])) + weights + [ws_in, ws_e] + ws_h + pad
      + [ws_gh] + ws_gp + pad)
  skip_mask = sum(1 << i for i in range(depth) if _is_skip(i, skips))
  lib = _build.load()
  target = _build.launch_target(device)

  def rows_chunk(rows):  # the chains' stride in a chunk's workspace
    return -(-rows // tile) * tile

  def row_pass(row0, rows):
    rc = lib.warp_train_backward_rows(
        ctypes.addressof(ptrs), n, row0, rows, rows_chunk(rows), c_in,
        f_embed, depth, skip_mask, nt, int(need_dx), width,
        *target)
    _check_launch(lib, rc, name)

  def weight_pass(row0, rows):
    stride = rows_chunk(rows)
    grads.run(lib, lambda j: stride * (chains if j['name'] in chained else 1),
              lambda j: stride, partial, flat, row0 > 0, target)

  def finish():
    dws = grads.views(flat)
    dws['w0'] = dws['w0'][:c_in]
    for key in list(dws):
      if key.startswith('wx'):
        dws[key] = dws[key][:c_in]
      elif key.startswith('we'):
        dws[key] = dws[key][:f_embed]
    dws['wh'] = dws['wh'][:, :_OUT_COLS]
    dws['bh'] = dws['bh'][:_OUT_COLS]
    return d_embed, dx, dts, dws

  passes = [(lambda c=c: row_pass(*c), lambda c=c: weight_pass(*c))
            for c in chunks]
  return passes, finish


def _launch_bwd(x, e, tangents, g_out, g_jouts, ops, trunk_depth, skips,
                need_dx, chunk=None):
  passes, finish = _bwd_passes(x, e, tangents, g_out, g_jouts, ops,
                               trunk_depth, skips, need_dx, chunk)
  for row_pass, weight_pass in passes:
    row_pass()
    weight_pass()
  warp_mlp_backward.launches += 1
  return finish()


# ---------------------------------------------------------------- wrappers

def warp_mlp_forward(x: torch.Tensor, embed: torch.Tensor,
                     tangents: Sequence[torch.Tensor], params: dict, *,
                     trunk_depth: int, skips: Tuple[int, ...]):
  """Fused warp trunk + head with 0 or 3 tangent chains.

  Args:
    x: (N, C) encodings; embed: (N, F) metadata embeddings; tangents: 0
      or 3 (N, C) tangent encodings. Any float dtype, used in bf16.
    params: {'trunk': ..., 'head': {'logit': ...}} (see `pack`).

  Returns:
    (out (N, 8) f32, [jout (N, 8) f32 per tangent]): the head output and
    its directional derivatives, head channels zero-padded to 8.
  """
  skips = tuple(skips)
  ops = pack(params, x.shape[1], embed.shape[1], trunk_depth, skips)
  if x.device.type == 'cpu':
    out, jouts, _ = _plain_fwd(x, embed, tangents, ops, trunk_depth, skips)
    return out, jouts
  if x.device.type != 'cuda':
    raise ValueError(f'warp_mlp_forward: no kernel for device {x.device}')
  return _launch_fwd(x, embed, tangents, ops, trunk_depth, skips)


warp_mlp_forward.launches = 0


def warp_mlp_backward(x, embed, tangents, params, g_out, g_jouts, *,
                      trunk_depth: int, skips: Tuple[int, ...],
                      need_dx: bool):
  """VJP of `warp_mlp_forward`.

  Returns:
    (d_embed (N, F) f32, dx (N, C) f32 or None, d_tangents (list of (N, C)
    f32) or None, dparams in the tree of `params`). dx and d_tangents are
    computed only with need_dx.
  """
  skips = tuple(skips)
  ops = pack(params, x.shape[1], embed.shape[1], trunk_depth, skips)
  if x.device.type == 'cpu':
    d_embed, dx, dts, dws = _plain_bwd(
        x, embed, tangents, g_out.float(), [g.float() for g in g_jouts], ops,
        trunk_depth, skips, need_dx)
  elif x.device.type == 'cuda':
    d_embed, dx, dts, dws = _launch_bwd(x, embed, tangents, g_out, g_jouts,
                                        ops, trunk_depth, skips, need_dx)
  else:
    raise ValueError(f'warp_mlp_backward: no kernel for device {x.device}')
  return d_embed, dx, dts, grads_to_tree(dws, params, trunk_depth, skips)


warp_mlp_backward.launches = 0


def warp_mlp_reference(x, embed, tangents, params, *, trunk_depth, skips):
  """Plain PyTorch version of `warp_mlp_forward` (same contract)."""
  skips = tuple(skips)
  ops = pack(params, x.shape[1], embed.shape[1], trunk_depth, skips)
  out, jouts, _ = _plain_fwd(x, embed, tangents, ops, trunk_depth, skips)
  return out, jouts


def warp_mlp_backward_reference(x, embed, tangents, params, g_out, g_jouts,
                                *, trunk_depth, skips, need_dx):
  """Plain PyTorch version of `warp_mlp_backward` (same contract)."""
  skips = tuple(skips)
  ops = pack(params, x.shape[1], embed.shape[1], trunk_depth, skips)
  d_embed, dx, dts, dws = _plain_bwd(
      x, embed, tangents, g_out.float(), [g.float() for g in g_jouts], ops,
      trunk_depth, skips, need_dx)
  return d_embed, dx, dts, grads_to_tree(dws, params, trunk_depth, skips)


class _WarpMlpTrain(torch.autograd.Function):
  """warp_mlp_forward with warp_mlp_backward as its VJP."""

  @staticmethod
  def forward(ctx, spec, x, embed, *rest):
    paths, trunk_depth, skips, nt = spec
    tangents, leaves = rest[:nt], rest[nt:]
    params = fused_mlp.unflatten_tree(paths, leaves)
    out, jouts = warp_mlp_forward(x, embed, tangents, params,
                                  trunk_depth=trunk_depth, skips=skips)
    ctx.spec = spec
    ctx.save_for_backward(x, embed, *rest)
    return (out, *jouts)

  @staticmethod
  def backward(ctx, g_out, *g_jouts):
    paths, trunk_depth, skips, nt = ctx.spec
    x, embed, *rest = ctx.saved_tensors
    tangents, leaves = rest[:nt], rest[nt:]
    params = fused_mlp.unflatten_tree(paths, leaves)
    need_dx = any(ctx.needs_input_grad[1:2] + ctx.needs_input_grad[3:3 + nt])
    d_embed, dx, dts, dparams = warp_mlp_backward(
        x, embed, tangents, params, g_out, list(g_jouts),
        trunk_depth=trunk_depth, skips=skips, need_dx=need_dx)
    grads = [fused_mlp.tree_leaf(dparams, p).to(leaf.dtype)
             for p, leaf in zip(paths, leaves)]
    dx = None if dx is None else dx.to(x.dtype)
    dts = ([None] * nt if dts is None
           else [d.to(t.dtype) for d, t in zip(dts, tangents)])
    return (None, dx, d_embed.to(embed.dtype), *dts, *grads)


def warp_mlp_train(x: torch.Tensor, embed: torch.Tensor,
                   tangents: Sequence[torch.Tensor], params: dict,
                   trunk_depth: int, skips: Tuple[int, ...]):
  """Differentiable fused warp trunk (nerfies_tpu fused_warp.warp_mlp_train).

  Returns (out (N, 8) f32, tuple of len(tangents) (N, 8) f32 jouts).
  """
  flat = fused_mlp.flatten_tree(params)
  spec = (tuple(p for p, _ in flat), trunk_depth, tuple(skips),
          len(tangents))
  outs = _WarpMlpTrain.apply(spec, x, embed, *tangents,
                             *[t for _, t in flat])
  return outs[0], tuple(outs[1:])
