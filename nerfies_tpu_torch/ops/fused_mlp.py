"""The NeRF MLP and the warp trunk as fused kernels, with their plain versions.

Port of three kernels of nerfies_tpu/ops/fused_mlp.py: `nerf_mlp_forward`
(:78), `warp_trunk_forward` (:645) and `_nerf_train_bwd` (:432), the
backward of `nerf_mlp_train`, with the same arguments and output
contracts. On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/fused_mlp.cu, csrc/fused_mlp_bwd.cu with csrc/weight_grad.cu, built
by ops/_build.py) and counts the launch in its `launches` attribute; on a
CPU tensor it runs the plain PyTorch version (`nerf_mlp_reference`,
`warp_trunk_reference`, `nerf_mlp_backward_reference`). It never falls
back from one to the other. `nerf_mlp_train` is the autograd Function of
the training path: its forward is `nerf_mlp_forward`, its backward
`nerf_mlp_backward`.

Numeric contract, shared by the kernels and the plain versions: bf16
operands and f32 accumulation; each layer's bias is bf16 and is added in
f32; a per-row bias is cast to bf16 first, then added in f32; ReLU is
taken in f32 and the result is stored as bf16 for the next layer; head
outputs are f32.

Operands keep the Flax (in, out) layout. The packing splits each skip
layer's kernel into the rows that read the hidden state and the rows that
read the positional encoding, and records from the param shapes which
heads read the bottleneck (`alpha_from_bt`, `rgb_from_bt`): a branch
reads the bottleneck only when it has a condition of its own, which makes
its first kernel taller than the trunk width. The kernels pad the
encoding to 64 columns and each head to 16; the plain versions pad the
heads to 8, which is the width of the outputs. Under torch.profiler the
packing and padding of the weights, forward and backward, is the range
`kernel.pack` (utils.span).
"""

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerfies_tpu_torch import utils
from nerfies_tpu_torch.ops import _build

# Shapes the kernels are built for (csrc/fused_mlp.cu): input columns are
# padded to _PE_PAD, heads to _HEAD_PAD; at most _MAX_DEPTH layers.
_PE_PAD = 64
_HEAD_PAD = 16
_MAX_DEPTH = 16
# (trunk width, rgb branch width) of the NeRF kernels: the bench and full
# configs (256, 128), configs/test_vrig.gin (128, 128) and the small
# verification model (32, 128).
_NERF_WIDTHS = ((256, 128), (128, 128), (32, 128))
# Every warp field of the config zoo is 128 wide (models/warping.py).
_WARP_WIDTHS = (128,)
_OUT_COLS = 8

# Bits of the NeRF kernel's `flags` argument.
_HAS_BOTTLENECK = 1
_ALPHA_FROM_BT = 2
_RGB_FROM_BT = 4
_HAS_RGB_HIDDEN = 8


def _bf16(t: torch.Tensor) -> torch.Tensor:
  return t.to(torch.bfloat16).contiguous()


def _pad_cols(t: torch.Tensor, to: int) -> torch.Tensor:
  pad = to - t.shape[-1]
  return t if pad <= 0 else F.pad(t, (0, pad))


def _pad_rows(t: torch.Tensor, to: int) -> torch.Tensor:
  pad = to - t.shape[0]
  return t if pad <= 0 else F.pad(t, (0, 0, 0, pad))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """bf16-valued operands, f32 products and sums, f32 result."""
  return a.float() @ b.float()


def _relu_bf16(acc: torch.Tensor) -> torch.Tensor:
  return torch.clamp(acc, min=0.0).to(torch.bfloat16)


# ----------------------------------------------------------------- packing

@dataclasses.dataclass
class NerfOperands:
  """One NerfMLP's params split into bf16 operands, in (in, out) layout."""
  width: int
  rgb_width: int
  trunk_w: list          # [i]: (c_in or width, width)
  trunk_wx: dict         # skip layer i: (c_in, width) rows that read x
  trunk_b: list          # [i]: (width,)
  bottleneck: Optional[Tuple[torch.Tensor, torch.Tensor]]
  alpha_w: torch.Tensor  # (width, 8)
  alpha_b: torch.Tensor  # (8,)
  rgb_hidden: Optional[Tuple[torch.Tensor, torch.Tensor]]
  rgb_w: torch.Tensor    # (rgb_width or width, 8)
  rgb_b: torch.Tensor    # (8,)
  alpha_from_bt: bool
  rgb_from_bt: bool


@utils.spanned('kernel.pack')
def pack_nerf_mlp(params: dict, c_in: int, trunk_depth: int,
                  skips: Sequence[int]) -> NerfOperands:
  """Splits the NerfMLP param tree into the operands of both versions."""
  k0 = params['trunk_hidden_0']['kernel']
  if k0.shape[0] != c_in:
    raise ValueError(
        'trunk layer 0 consumes extra (condition) rows; the fused MLP '
        'supports trunk_condition=None only')
  width = k0.shape[1]
  trunk_w, trunk_wx, trunk_b = [], {}, []
  for i in range(trunk_depth):
    k = params[f'trunk_hidden_{i}']['kernel']
    if i != 0 and i in skips:
      trunk_w.append(_bf16(k[:width]))
      trunk_wx[i] = _bf16(k[width:width + c_in])
    else:
      trunk_w.append(_bf16(k))
    trunk_b.append(_bf16(params[f'trunk_hidden_{i}']['bias']))

  has_bottleneck = 'bottleneck' in params
  has_rgb_hidden = 'rgb_hidden_0' in params
  alpha_k = params['alpha_logit']['kernel']
  rgb_first_k = (params['rgb_hidden_0']['kernel'] if has_rgb_hidden
                 else params['rgb_logit']['kernel'])
  bottleneck = None
  if has_bottleneck:
    bottleneck = (_bf16(params['bottleneck']['kernel']),
                  _bf16(params['bottleneck']['bias']))
  rgb_hidden = None
  rgb_width = width
  if has_rgb_hidden:
    # Rows [0:width] read the trunk or bottleneck; the condition rows are
    # folded into rgb_row_bias by the caller.
    rk = params['rgb_hidden_0']['kernel']
    rgb_hidden = (_bf16(rk[:width]), _bf16(params['rgb_hidden_0']['bias']))
    rgb_width = rk.shape[1]
  rgb_logit_k = params['rgb_logit']['kernel']
  if rgb_logit_k.shape[0] != rgb_width:
    raise ValueError('the rgb head reads condition rows directly; the fused '
                     'MLP needs an rgb hidden layer to carry conditions')
  return NerfOperands(
      width=width,
      rgb_width=rgb_width,
      trunk_w=trunk_w,
      trunk_wx=trunk_wx,
      trunk_b=trunk_b,
      bottleneck=bottleneck,
      alpha_w=_bf16(_pad_cols(alpha_k[:width], _OUT_COLS)),
      alpha_b=_bf16(_pad_cols(params['alpha_logit']['bias'], _OUT_COLS)),
      rgb_hidden=rgb_hidden,
      rgb_w=_bf16(_pad_cols(rgb_logit_k, _OUT_COLS)),
      rgb_b=_bf16(_pad_cols(params['rgb_logit']['bias'], _OUT_COLS)),
      # A branch reads the bottleneck only when it has its own condition,
      # which makes its first kernel taller than the trunk width.
      alpha_from_bt=has_bottleneck and alpha_k.shape[0] > width,
      rgb_from_bt=has_bottleneck and rgb_first_k.shape[0] > width)


@dataclasses.dataclass
class WarpOperands:
  """The warp trunk and its linear head as bf16 operands."""
  width: int
  trunk_w: list   # [0]: (c_in, width); skip layers (width, width)
  trunk_wx: dict  # skip layer i: (c_in, width)
  trunk_b: list
  head_w: torch.Tensor  # (width, 8)
  head_b: torch.Tensor  # (8,)


@utils.spanned('kernel.pack')
def pack_warp_trunk(params: dict, c_in: int, trunk_depth: int,
                    skips: Sequence[int],
                    head_key: str = 'branches_wv') -> WarpOperands:
  """Splits a warp field's trunk and head into bf16 operands.

  Rows of layer 0 and of each skip layer beyond the encoding's (the
  metadata embedding's) are left out: they enter as per-row biases.
  """
  trunk = params['trunk']
  width = trunk['hidden_0']['kernel'].shape[1]
  trunk_w, trunk_wx, trunk_b = [], {}, []
  for i in range(trunk_depth):
    k = trunk[f'hidden_{i}']['kernel']
    if i == 0:
      trunk_w.append(_bf16(k[:c_in]))
    elif i in skips:
      trunk_w.append(_bf16(k[:width]))
      trunk_wx[i] = _bf16(k[width:width + c_in])
    else:
      trunk_w.append(_bf16(k))
    trunk_b.append(_bf16(trunk[f'hidden_{i}']['bias']))
  head = params[head_key]['logit']
  return WarpOperands(
      width=width, trunk_w=trunk_w, trunk_wx=trunk_wx, trunk_b=trunk_b,
      head_w=_bf16(_pad_cols(head['kernel'], _OUT_COLS)),
      head_b=_bf16(_pad_cols(head['bias'], _OUT_COLS)))


# --------------------------------------------------------- plain versions

def _nerf_plain(x, rgb_row_bias, ops: NerfOperands, trunk_depth, skips):
  xt = x.to(torch.bfloat16)
  h = None
  for i in range(trunk_depth):
    acc = _dot(xt if h is None else h, ops.trunk_w[i])
    if i in ops.trunk_wx:
      acc = acc + _dot(xt, ops.trunk_wx[i])
    h = _relu_bf16(acc + ops.trunk_b[i].float())
  if ops.bottleneck is not None:
    bw, bb = ops.bottleneck
    bt = (_dot(h, bw) + bb.float()).to(torch.bfloat16)
  else:
    bt = h
  alpha = _dot(bt if ops.alpha_from_bt else h, ops.alpha_w) + ops.alpha_b.float()
  y = bt if ops.rgb_from_bt else h
  if ops.rgb_hidden is not None:
    rw, rb = ops.rgb_hidden
    acc = _dot(y, rw) + rb.float()
    if rgb_row_bias is not None:
      acc = acc + rgb_row_bias.to(torch.bfloat16).float()
    y = _relu_bf16(acc)
  rgb = _dot(y, ops.rgb_w) + ops.rgb_b.float()
  return alpha, rgb


def nerf_mlp_reference(x: torch.Tensor,
                       rgb_row_bias: Optional[torch.Tensor],
                       params: dict,
                       *,
                       trunk_depth: int,
                       skips: Tuple[int, ...]):
  """Plain PyTorch version of `nerf_mlp_forward` (same contract)."""
  ops = pack_nerf_mlp(params, x.shape[1], trunk_depth, skips)
  return _nerf_plain(x, rgb_row_bias, ops, trunk_depth, tuple(skips))


def _warp_plain(x, row_biases, ops: WarpOperands, trunk_depth):
  xt = x.to(torch.bfloat16)
  bias_map = dict(row_biases)
  h = None
  for i in range(trunk_depth):
    acc = _dot(xt if h is None else h, ops.trunk_w[i])
    if i in ops.trunk_wx:
      acc = acc + _dot(xt, ops.trunk_wx[i])
    if i in bias_map:
      acc = acc + bias_map[i].to(torch.bfloat16).float()
    h = _relu_bf16(acc + ops.trunk_b[i].float())
  return _dot(h, ops.head_w) + ops.head_b.float()


def warp_trunk_reference(x: torch.Tensor,
                         row_biases: Sequence[Tuple[int, torch.Tensor]],
                         params: dict,
                         *,
                         trunk_depth: int,
                         skips: Tuple[int, ...],
                         head_key: str = 'branches_wv') -> torch.Tensor:
  """Plain PyTorch version of `warp_trunk_forward` (same contract)."""
  ops = pack_warp_trunk(params, x.shape[1], trunk_depth, skips, head_key)
  return _warp_plain(x, row_biases, ops, trunk_depth)


# ---------------------------------------------------------------- kernels

def _ptr(t: Optional[torch.Tensor]) -> int:
  return 0 if t is None else t.data_ptr()


def _pointer_array(tensors) -> ctypes.Array:
  return (ctypes.c_void_p * len(tensors))(*[_ptr(t) for t in tensors])


def _check_launch(lib, rc: int, name: str) -> None:
  if rc != 0:
    raise RuntimeError(f'{name}: CUDA error {rc}: '
                       f'{lib.fused_mlp_error_string(rc).decode()}')


def _check_rows(x: torch.Tensor, name: str) -> None:
  if x.dim() != 2 or x.shape[0] <= 0:
    raise ValueError(f'{name}: x must be (N, C) with N > 0, got {tuple(x.shape)}')
  if x.shape[1] > _PE_PAD:
    raise ValueError(f'{name}: the kernel takes at most {_PE_PAD} input '
                     f'columns, got {x.shape[1]}')


def _check_row_bias(b: torch.Tensor, x: torch.Tensor, width: int,
                    name: str) -> torch.Tensor:
  if b.device != x.device or tuple(b.shape) != (x.shape[0], width):
    raise ValueError(f'{name}: row bias must be ({x.shape[0]}, {width}) on '
                     f'{x.device}, got {tuple(b.shape)} on {b.device}')
  return _bf16(b)


def _check_operands(tensors, device, name: str) -> None:
  for t in tensors:
    if t.device != device:
      raise ValueError(f'{name}: params must lie on {device}, not {t.device}')
    if t.data_ptr() % 16:
      raise ValueError(f'{name}: operands must be 16-byte aligned')


def check_nerf_shape(name: str, width: int, rgb_width: int, trunk_depth: int,
                     c_in: int) -> None:
  """Raises ValueError unless the NeRF kernels are built for this shape."""
  if (width, rgb_width) not in _NERF_WIDTHS:
    raise ValueError(f'{name}: kernels built for (width, rgb width) in '
                     f'{_NERF_WIDTHS}, got {(width, rgb_width)}')
  if not 1 <= trunk_depth <= _MAX_DEPTH:
    raise ValueError(f'{name}: trunk depth must be in [1, {_MAX_DEPTH}], '
                     f'got {trunk_depth}')
  if not 1 <= c_in <= _PE_PAD:
    raise ValueError(f'{name}: the kernels take 1 to {_PE_PAD} input '
                     f'columns, got {c_in}')


def _launch_nerf(x, rgb_row_bias, ops: NerfOperands, trunk_depth, skips):
  name = 'nerf_mlp_forward'
  _check_rows(x, name)
  check_nerf_shape(name, ops.width, ops.rgb_width, trunk_depth, x.shape[1])
  n, c_in = x.shape
  x = x.float().contiguous()
  if ops.rgb_hidden is None or rgb_row_bias is None:
    rgb_row_bias = None
  else:
    rgb_row_bias = _check_row_bias(rgb_row_bias, x, ops.rgb_width, name)

  with utils.span('kernel.pack'):
    w = [_pad_rows(ops.trunk_w[0], _PE_PAD).contiguous()] + ops.trunk_w[1:]
    wx = [(_pad_rows(ops.trunk_wx[i], _PE_PAD).contiguous()
           if i in ops.trunk_wx else None) for i in range(_MAX_DEPTH)]
    pad = [None] * (_MAX_DEPTH - trunk_depth)
    bot_w, bot_b = ops.bottleneck or (None, None)
    rh_w, rh_b = ops.rgb_hidden or (None, None)
    head = lambda t: _pad_cols(t, _HEAD_PAD).contiguous()
    weights = (w + pad + wx + ops.trunk_b + pad
               + [bot_w, bot_b, head(ops.alpha_w), head(ops.alpha_b),
                  rh_w, rh_b, head(ops.rgb_w), head(ops.rgb_b)])
  _check_operands([t for t in weights if t is not None], x.device, name)

  alpha = torch.empty((n, _OUT_COLS), dtype=torch.float32, device=x.device)
  rgb = torch.empty((n, _OUT_COLS), dtype=torch.float32, device=x.device)
  flags = ((_HAS_BOTTLENECK if ops.bottleneck is not None else 0)
           | (_ALPHA_FROM_BT if ops.alpha_from_bt else 0)
           | (_RGB_FROM_BT if ops.rgb_from_bt else 0)
           | (_HAS_RGB_HIDDEN if ops.rgb_hidden is not None else 0))
  skip_mask = sum(1 << i for i in ops.trunk_wx)
  ptrs = _pointer_array([x, rgb_row_bias, alpha, rgb] + weights)
  lib = _build.load()
  rc = lib.nerf_mlp_forward(
      ctypes.addressof(ptrs), n, c_in, trunk_depth, skip_mask, flags,
      ops.width, ops.rgb_width, *_build.launch_target(x.device))
  _check_launch(lib, rc, name)
  nerf_mlp_forward.launches += 1
  return alpha, rgb


def nerf_mlp_forward(x: torch.Tensor,
                     rgb_row_bias: Optional[torch.Tensor],
                     params: dict,
                     *,
                     trunk_depth: int,
                     skips: Tuple[int, ...]):
  """Fused forward of NerfMLP (rgb branch depth 1, alpha branch depth 0).

  Args:
    x: (N, C_pe) point encodings, N > 0.
    rgb_row_bias: (N, rgb_width) per-row rgb condition term
      (cond @ rgb_hidden_kernel[width:]), or None.
    params: one NerfMLP's param tree ({'trunk_hidden_i': {kernel, bias}},
      'bottleneck'?, 'rgb_hidden_0'?, 'rgb_logit', 'alpha_logit').
    trunk_depth / skips: static architecture.

  Returns:
    (alpha, rgb), each (N, 8) f32: alpha[:, 0] is the raw sigma without
    the per-ray alpha-condition term, rgb[:, :3] the raw rgb logits.
  """
  ops = pack_nerf_mlp(params, x.shape[-1], trunk_depth, skips)
  if x.device.type == 'cpu':
    return _nerf_plain(x, rgb_row_bias, ops, trunk_depth, tuple(skips))
  if x.device.type != 'cuda':
    raise ValueError(f'nerf_mlp_forward: no kernel for device {x.device}')
  return _launch_nerf(x, rgb_row_bias, ops, trunk_depth, tuple(skips))


nerf_mlp_forward.launches = 0


def _launch_warp(x, row_biases, ops: WarpOperands, trunk_depth):
  name = 'warp_trunk_forward'
  _check_rows(x, name)
  if ops.width not in _WARP_WIDTHS:
    raise ValueError(f'{name}: kernel built for widths {_WARP_WIDTHS}, '
                     f'got {ops.width}')
  if not 1 <= trunk_depth <= _MAX_DEPTH:
    raise ValueError(f'{name}: trunk depth must be in [1, {_MAX_DEPTH}]')
  n, c_in = x.shape
  x = x.float().contiguous()
  rb = [None] * _MAX_DEPTH
  for layer, b in row_biases:
    if not 0 <= layer < trunk_depth:
      raise ValueError(f'{name}: row bias for layer {layer} of {trunk_depth}')
    rb[layer] = _check_row_bias(b, x, ops.width, name)

  with utils.span('kernel.pack'):
    w = [_pad_rows(ops.trunk_w[0], _PE_PAD).contiguous()] + ops.trunk_w[1:]
    wx = [(_pad_rows(ops.trunk_wx[i], _PE_PAD).contiguous()
           if i in ops.trunk_wx else None) for i in range(_MAX_DEPTH)]
    pad = [None] * (_MAX_DEPTH - trunk_depth)
    weights = (w + pad + wx + ops.trunk_b + pad
               + [_pad_cols(ops.head_w, _HEAD_PAD).contiguous(),
                  _pad_cols(ops.head_b, _HEAD_PAD).contiguous()])
  _check_operands([t for t in weights if t is not None], x.device, name)

  out = torch.empty((n, _OUT_COLS), dtype=torch.float32, device=x.device)
  skip_mask = sum(1 << i for i in ops.trunk_wx)
  ptrs = _pointer_array([x, out] + weights + rb)
  lib = _build.load()
  rc = lib.warp_trunk_forward(
      ctypes.addressof(ptrs), n, c_in, trunk_depth, skip_mask, ops.width,
      *_build.launch_target(x.device))
  _check_launch(lib, rc, name)
  warp_trunk_forward.launches += 1
  return out


def warp_trunk_forward(x: torch.Tensor,
                       row_biases: Sequence[Tuple[int, torch.Tensor]],
                       params: dict,
                       *,
                       trunk_depth: int,
                       skips: Tuple[int, ...],
                       head_key: str = 'branches_wv') -> torch.Tensor:
  """Fused forward of the SE(3)/translation warp trunk and its linear head.

  Args:
    x: (N, C_pe) warp point encodings, N > 0.
    row_biases: [(layer, (N, width) bias)] per-row terms (the metadata
      embedding's contribution at layer 0 and at each skip).
    params: warp param subtree with 'trunk' and the head under `head_key`.
    trunk_depth / skips: static architecture.
    head_key: name of the head branch holding {'logit': {kernel, bias}}.

  Returns:
    (N, 8) f32 head output, head channels zero-padded to 8.
  """
  ops = pack_warp_trunk(params, x.shape[-1], trunk_depth, skips, head_key)
  if x.device.type == 'cpu':
    return _warp_plain(x, row_biases, ops, trunk_depth)
  if x.device.type != 'cuda':
    raise ValueError(f'warp_trunk_forward: no kernel for device {x.device}')
  return _launch_warp(x, row_biases, ops, trunk_depth)


warp_trunk_forward.launches = 0




# ------------------------------------------------------ training backward
#
# nerf_mlp_train's backward: the VJP of nerf_mlp_forward with the rounding
# points of nerfies_tpu/ops/fused_mlp.py:432 _nerf_train_bwd: the
# activations are recomputed in bf16; g_alpha, g_rgb and every cotangent
# that feeds a product are rounded to bf16; ReLU masks compare the bf16
# activation with 0 in f32; dx sums the skip layer's and layer 0's f32
# products in that order; dW and the bias gradients are f32 sums of
# products of bf16 values.

# Rows per pass of the backward kernels: the workspace of the NeRF MLP's
# row pass holds 9,920 bytes per row at the bench widths, so 2.6 GB for a
# chunk of 262,144 rows. The chunk is a multiple of the row pass's tile.
_NERF_BWD_CHUNK = 262144
_NERF_BWD_TILE = 128  # rows per block of csrc/fused_mlp_bwd.cu
_DW_ALIGN = 64  # floats between job offsets in the flat dW buffer
_DW_TILE_M = 128  # dW rows per block of weight_grad.cu
# Blocks per SM that the weight-gradient pass aims for, through its row
# splits: several waves even out tiles of unequal work.
_DW_WAVES = 6


def _nerf_plain_bwd(x, rgb_row_bias, ops: NerfOperands, trunk_depth,
                    g_alpha, g_rgb):
  """Plain version of the backward: (dx, drb or None, {name: f32 dW})."""
  if ops.rgb_hidden is None:
    raise ValueError('nerf_mlp_backward: needs an rgb hidden layer, as '
                     '_nerf_train_bwd does')
  xt = x.to(torch.bfloat16)
  hs = []
  h = None
  for i in range(trunk_depth):
    acc = _dot(xt if h is None else h, ops.trunk_w[i])
    if i in ops.trunk_wx:
      acc = acc + _dot(xt, ops.trunk_wx[i])
    h = _relu_bf16(acc + ops.trunk_b[i].float())
    hs.append(h)
  bt = h
  if ops.bottleneck is not None:
    bw, bb = ops.bottleneck
    bt = (_dot(h, bw) + bb.float()).to(torch.bfloat16)
  rw, rbias = ops.rgb_hidden
  r_src = bt if ops.rgb_from_bt else h
  a_src = bt if ops.alpha_from_bt else h
  acc = _dot(r_src, rw) + rbias.float()
  if rgb_row_bias is not None:
    acc = acc + rgb_row_bias.to(torch.bfloat16).float()
  y = _relu_bf16(acc)

  dws = {}
  ga = g_alpha.to(torch.bfloat16)
  gr = g_rgb.to(torch.bfloat16)
  gy = (_dot(gr, ops.rgb_w.t()) * (y.float() > 0)).to(torch.bfloat16)
  dws['rgb_logit/w'] = _dot(y.t(), gr)
  dws['rgb_logit/b'] = gr.float().sum(0)
  drb = gy.float() if rgb_row_bias is not None else None
  dws['rgb_hidden/w'] = _dot(r_src.t(), gy)
  dws['rgb_hidden/b'] = gy.float().sum(0)
  dws['alpha_logit/w'] = _dot(a_src.t(), ga)
  dws['alpha_logit/b'] = ga.float().sum(0)
  g_rgb_in = _dot(gy, rw.t())
  g_alpha_in = _dot(ga, ops.alpha_w.t())
  if ops.bottleneck is not None:
    zero = torch.zeros_like(g_rgb_in)
    g_bt = ((g_rgb_in if ops.rgb_from_bt else zero)
            + (g_alpha_in if ops.alpha_from_bt else zero)).to(torch.bfloat16)
    g_h = ((zero if ops.rgb_from_bt else g_rgb_in)
           + (zero if ops.alpha_from_bt else g_alpha_in)
           + _dot(g_bt, ops.bottleneck[0].t())).to(torch.bfloat16)
    dws['bottleneck/w'] = _dot(hs[-1].t(), g_bt)
    dws['bottleneck/b'] = g_bt.float().sum(0)
  else:
    g_h = (g_rgb_in + g_alpha_in).to(torch.bfloat16)

  gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
  for i in range(trunk_depth - 1, -1, -1):
    g_pre = (g_h.float() * (hs[i].float() > 0)).to(torch.bfloat16)
    src = xt if i == 0 else hs[i - 1]
    dws[f'trunk_{i}/w'] = _dot(src.t(), g_pre)
    dws[f'trunk_{i}/b'] = g_pre.float().sum(0)
    if i in ops.trunk_wx:
      dws[f'trunk_{i}/wx'] = _dot(xt.t(), g_pre)
      gx = gx + _dot(g_pre, ops.trunk_wx[i].t())
    if i == 0:
      gx = gx + _dot(g_pre, ops.trunk_w[0].t())
    else:
      g_h = _dot(g_pre, ops.trunk_w[i].t()).to(torch.bfloat16)
  return gx, drb, dws


def _nerf_grads_to_tree(dws, params, ops: NerfOperands, trunk_depth, skips):
  """Scatters packed dW into the param tree's shapes (fused_mlp.py:591-637).

  The condition rows of the rgb hidden and alpha heads get zeros here:
  their gradient reaches them through the caller's row-bias product.
  """
  width = ops.width
  tree = {}
  for i in range(trunk_depth):
    kernel = dws[f'trunk_{i}/w']
    if i != 0 and i in skips:
      kernel = torch.cat([kernel, dws[f'trunk_{i}/wx']], 0)
    tree[f'trunk_hidden_{i}'] = {'kernel': kernel,
                                 'bias': dws[f'trunk_{i}/b']}
  if ops.bottleneck is not None:
    tree['bottleneck'] = {'kernel': dws['bottleneck/w'],
                          'bias': dws['bottleneck/b']}

  def with_condition_rows(grad, rows):
    if rows == width:
      return grad
    return torch.cat([grad, grad.new_zeros(rows - width, grad.shape[1])], 0)

  tree['rgb_hidden_0'] = {
      'kernel': with_condition_rows(
          dws['rgb_hidden/w'], params['rgb_hidden_0']['kernel'].shape[0]),
      'bias': dws['rgb_hidden/b']}
  rgb_ch = params['rgb_logit']['kernel'].shape[1]
  tree['rgb_logit'] = {'kernel': dws['rgb_logit/w'][:, :rgb_ch],
                       'bias': dws['rgb_logit/b'][:rgb_ch]}
  alpha_k = params['alpha_logit']['kernel']
  tree['alpha_logit'] = {
      'kernel': with_condition_rows(dws['alpha_logit/w'][:, :alpha_k.shape[1]],
                                    alpha_k.shape[0]),
      'bias': dws['alpha_logit/b'][:alpha_k.shape[1]]}
  return tree


def nerf_mlp_backward_reference(x, rgb_row_bias, params, g_alpha, g_rgb, *,
                                trunk_depth: int, skips: Tuple[int, ...]):
  """Plain PyTorch version of `nerf_mlp_backward` (same contract)."""
  ops = pack_nerf_mlp(params, x.shape[1], trunk_depth, skips)
  dx, drb, dws = _nerf_plain_bwd(x, rgb_row_bias, ops, trunk_depth,
                                 g_alpha.float(), g_rgb.float())
  return dx, drb, _nerf_grads_to_tree(dws, params, ops, trunk_depth,
                                      tuple(skips))


class _WeightGrads:
  """The jobs of weight_grad.cu and the flat f32 buffer they fill.

  A job is one weight: dW (m x n) = A^T @ G over `rows` rows of two bf16
  workspace arrays, plus the column sums of G over its first `bias_rows`
  rows when the weight has a bias. Offsets are multiples of _DW_ALIGN.
  """

  def __init__(self):
    self.jobs = []
    self.size = 0

  def _take(self, count):
    offset = self.size
    self.size += -(-count // _DW_ALIGN) * _DW_ALIGN
    return offset

  def add(self, name, a, g, bias_name=None):
    m, n = a.shape[1], g.shape[1]
    out = self._take(m * n)
    bias_out = self._take(n) if bias_name else 0
    self.jobs.append(dict(name=name, bias_name=bias_name, a=a, g=g, m=m, n=n,
                          out=out, bias_out=bias_out))

  @property
  def tile_n(self):
    """The block tile's columns: every job's n, so each reads A once."""
    return 256 if max(j['n'] for j in self.jobs) > 128 else 128

  def run(self, lib, rows_of, bias_rows_of, partial, flat, accumulate,
          target):
    """One chunk: rows_of(job) rows, bias over bias_rows_of(job) rows;
    `target` is the launch's (card, stream), _build.launch_target."""
    ptrs = _pointer_array([t for j in self.jobs for t in (j['a'], j['g'])])
    ints = []
    for j in self.jobs:
      ints += [j['a'].shape[1], j['g'].shape[1], j['m'], j['n'], rows_of(j),
               bias_rows_of(j) if j['bias_name'] else 0, j['out'],
               j['bias_out']]
    int_array = (ctypes.c_int * len(ints))(*ints)
    splits = partial.numel() // self.size
    rc = lib.weight_grad(ctypes.addressof(ptrs), ctypes.addressof(int_array),
                         len(self.jobs), self.tile_n, splits,
                         partial.data_ptr(), self.size, flat.data_ptr(),
                         int(accumulate), *target)
    _check_launch(lib, rc, 'weight_grad')

  def splits(self, sms):
    """Row splits that give each of `sms` SMs about _DW_WAVES blocks.

    Each tile counts by the share of a full tile it covers; weight_grad.cu
    runs one block per SM at a time.
    """
    tn = self.tile_n
    work = 0.0
    for j in self.jobs:
      for m0 in range(0, j['m'], _DW_TILE_M):
        for n0 in range(0, j['n'], tn):
          work += (min(_DW_TILE_M, j['m'] - m0) / _DW_TILE_M
                   * min(tn, j['n'] - n0) / tn)
    return max(1, min(64, int(_DW_WAVES * sms / work)))

  def views(self, flat):
    out = {}
    for j in self.jobs:
      out[j['name']] = flat[j['out']:j['out'] + j['m'] * j['n']].view(
          j['m'], j['n'])
      if j['bias_name']:
        out[j['bias_name']] = flat[j['bias_out']:j['bias_out'] + j['n']]
    return out


def _sm_count(device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


def _workspace(device, shapes):
  """One bf16 allocation cut into row-major arrays of the given shapes."""
  sizes = [-(-r * c // 8) * 8 for r, c in shapes]  # 16-byte aligned views
  buf = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device)
  views, offset = [], 0
  for (r, c), size in zip(shapes, sizes):
    views.append(buf[offset:offset + r * c].view(r, c))
    offset += size
  return views


def _nerf_bwd_passes(x, rgb_row_bias, ops: NerfOperands, trunk_depth,
                     g_alpha, g_rgb, chunk=_NERF_BWD_CHUNK):
  """The checks, outputs and workspace of one kernel backward.

  Returns (passes, finish): one (row_pass, weight_pass) pair of callables
  per chunk of rows, each launching its kernel on the current stream and
  to be called in order; finish() gives (dx, drb, {name: dW}) after all.
  """
  name = 'nerf_mlp_backward'
  _check_rows(x, name)
  check_nerf_shape(name, ops.width, ops.rgb_width, trunk_depth, x.shape[1])
  if chunk % _NERF_BWD_TILE:
    raise ValueError(f'{name}: chunk must be a multiple of {_NERF_BWD_TILE}')
  if ops.rgb_hidden is None:
    raise ValueError(f'{name}: needs an rgb hidden layer')
  n, c_in = x.shape
  width, rgb_width = ops.width, ops.rgb_width
  device = x.device
  x = x.float().contiguous()
  for g in (g_alpha, g_rgb):
    if g.device != device or tuple(g.shape) != (n, _OUT_COLS):
      raise ValueError(f'{name}: cotangents must be ({n}, {_OUT_COLS}) on '
                       f'{device}, got {tuple(g.shape)} on {g.device}')
  g_alpha = g_alpha.float().contiguous()
  g_rgb = g_rgb.float().contiguous()
  if rgb_row_bias is not None:
    rgb_row_bias = _check_row_bias(rgb_row_bias, x, rgb_width, name)

  # The kernel reads every weight in its (in, out) layout, also where it
  # multiplies by the transpose: no transposed copies.
  with utils.span('kernel.pack'):
    w = [_pad_rows(ops.trunk_w[0], _PE_PAD).contiguous()] + ops.trunk_w[1:]
    wx = [(_pad_rows(ops.trunk_wx[i], _PE_PAD).contiguous()
           if i in ops.trunk_wx else None) for i in range(_MAX_DEPTH)]
    pad = [None] * (_MAX_DEPTH - trunk_depth)
    bot_w, bot_b = ops.bottleneck or (None, None)
    rh_w, rh_b = ops.rgb_hidden
    head = lambda t: _pad_cols(t, _HEAD_PAD).contiguous()
    weights = (w + pad + wx + ops.trunk_b + pad
               + [bot_w, bot_b, head(ops.alpha_w), rh_w, rh_b,
                  head(ops.rgb_w)])
  _check_operands([t for t in weights if t is not None], device, name)

  # The row pass writes whole tiles of _NERF_BWD_TILE rows.
  rows_alloc = min(-(-n // _NERF_BWD_TILE) * _NERF_BWD_TILE, chunk)
  has_bt = ops.bottleneck is not None
  depth = trunk_depth
  shapes = ([(rows_alloc, _PE_PAD)] + [(rows_alloc, width)] * depth
            + [(rows_alloc, width)] * has_bt + [(rows_alloc, rgb_width)]
            + [(rows_alloc, width)] * depth + [(rows_alloc, width)] * has_bt
            + [(rows_alloc, rgb_width), (rows_alloc, _HEAD_PAD),
               (rows_alloc, _HEAD_PAD)])
  views = iter(_workspace(device, shapes))
  ws_x = next(views)
  ws_h = [next(views) for _ in range(depth)]
  ws_bt = next(views) if has_bt else None
  ws_y = next(views)
  ws_gp = [next(views) for _ in range(depth)]
  ws_gbt = next(views) if has_bt else None
  ws_gy, ws_ga, ws_gr = next(views), next(views), next(views)

  grads = _WeightGrads()
  for i in range(depth):
    grads.add(f'trunk_{i}/w', ws_x if i == 0 else ws_h[i - 1], ws_gp[i],
              f'trunk_{i}/b')
    if i in ops.trunk_wx:
      grads.add(f'trunk_{i}/wx', ws_x, ws_gp[i])
  if has_bt:
    grads.add('bottleneck/w', ws_h[-1], ws_gbt, 'bottleneck/b')
  grads.add('rgb_hidden/w', ws_bt if ops.rgb_from_bt else ws_h[-1], ws_gy,
            'rgb_hidden/b')
  grads.add('alpha_logit/w', ws_bt if ops.alpha_from_bt else ws_h[-1], ws_ga,
            'alpha_logit/b')
  grads.add('rgb_logit/w', ws_y, ws_gr, 'rgb_logit/b')
  partial = torch.empty(grads.splits(_sm_count(device)) * grads.size,
                        dtype=torch.float32, device=device)
  flat = torch.empty(grads.size, dtype=torch.float32, device=device)

  dx = torch.empty((n, c_in), dtype=torch.float32, device=device)
  drb = (torch.empty((n, rgb_width), dtype=torch.float32, device=device)
         if rgb_row_bias is not None else None)
  workspace = ([ws_x] + ws_h + [None] * (_MAX_DEPTH - depth) + [ws_bt, ws_y]
               + ws_gp + [None] * (_MAX_DEPTH - depth)
               + [ws_gbt, ws_gy, ws_ga, ws_gr])
  ptrs = _pointer_array([x, rgb_row_bias, g_alpha, g_rgb, dx, drb] + weights
                        + workspace)
  flags = ((_HAS_BOTTLENECK if has_bt else 0)
           | (_ALPHA_FROM_BT if ops.alpha_from_bt else 0)
           | (_RGB_FROM_BT if ops.rgb_from_bt else 0))
  skip_mask = sum(1 << i for i in ops.trunk_wx)
  lib = _build.load()
  target = _build.launch_target(device)

  def row_pass(row0, rows):
    rc = lib.nerf_mlp_backward_rows(
        ctypes.addressof(ptrs), row0, rows, c_in, depth, skip_mask, flags,
        width, rgb_width, *target)
    _check_launch(lib, rc, name)

  def weight_pass(row0, rows):
    grads.run(lib, lambda j: rows, lambda j: rows, partial, flat, row0 > 0,
              target)

  def finish():
    dws = grads.views(flat)
    dws['trunk_0/w'] = dws['trunk_0/w'][:c_in]
    for i in ops.trunk_wx:
      dws[f'trunk_{i}/wx'] = dws[f'trunk_{i}/wx'][:c_in]
    for key in ('alpha_logit', 'rgb_logit'):
      dws[f'{key}/w'] = dws[f'{key}/w'][:, :_OUT_COLS]
      dws[f'{key}/b'] = dws[f'{key}/b'][:_OUT_COLS]
    return dx, drb, dws

  chunks = [(row0, min(rows_alloc, n - row0))
            for row0 in range(0, n, rows_alloc)]
  passes = [(lambda c=c: row_pass(*c), lambda c=c: weight_pass(*c))
            for c in chunks]
  return passes, finish


def _launch_nerf_bwd(x, rgb_row_bias, ops: NerfOperands, trunk_depth,
                     g_alpha, g_rgb, chunk=_NERF_BWD_CHUNK):
  passes, finish = _nerf_bwd_passes(x, rgb_row_bias, ops, trunk_depth,
                                    g_alpha, g_rgb, chunk)
  for row_pass, weight_pass in passes:
    row_pass()
    weight_pass()
  nerf_mlp_backward.launches += 1
  return finish()


def nerf_mlp_backward(x: torch.Tensor,
                      rgb_row_bias: Optional[torch.Tensor],
                      params: dict,
                      g_alpha: torch.Tensor,
                      g_rgb: torch.Tensor,
                      *,
                      trunk_depth: int,
                      skips: Tuple[int, ...]):
  """VJP of `nerf_mlp_forward` (rgb branch depth 1, alpha branch depth 0).

  Args:
    x / rgb_row_bias / params / trunk_depth / skips: as nerf_mlp_forward.
    g_alpha, g_rgb: (N, 8) cotangents of its two outputs.

  Returns:
    (dx (N, C_pe) f32, drb (N, rgb_width) f32 or None, dparams): dparams
    has the param tree's names and shapes; the condition rows of the rgb
    hidden and alpha kernels hold zeros (their gradient flows through the
    caller's row-bias product).
  """
  ops = pack_nerf_mlp(params, x.shape[-1], trunk_depth, skips)
  skips = tuple(skips)
  if x.device.type == 'cpu':
    dx, drb, dws = _nerf_plain_bwd(x, rgb_row_bias, ops, trunk_depth,
                                   g_alpha.float(), g_rgb.float())
  elif x.device.type == 'cuda':
    dx, drb, dws = _launch_nerf_bwd(x, rgb_row_bias, ops, trunk_depth,
                                    g_alpha, g_rgb)
  else:
    raise ValueError(f'nerf_mlp_backward: no kernel for device {x.device}')
  return dx, drb, _nerf_grads_to_tree(dws, params, ops, trunk_depth, skips)


nerf_mlp_backward.launches = 0


# ------------------------------------------------------- autograd wiring

def flatten_tree(tree: dict, prefix=()):
  """[(path, tensor)] of a nested dict, in its iteration order."""
  out = []
  for key, value in tree.items():
    if isinstance(value, dict):
      out += flatten_tree(value, prefix + (key,))
    else:
      out.append((prefix + (key,), value))
  return out


def unflatten_tree(paths, leaves) -> dict:
  tree = {}
  for path, leaf in zip(paths, leaves):
    node = tree
    for key in path[:-1]:
      node = node.setdefault(key, {})
    node[path[-1]] = leaf
  return tree


def tree_leaf(tree: dict, path):
  for key in path:
    tree = tree[key]
  return tree


class _NerfMlpTrain(torch.autograd.Function):
  """nerf_mlp_forward with nerf_mlp_backward as its VJP.

  Params enter as a flat list of leaves so that autograd sees them; the
  first argument carries their paths and the static architecture.
  """

  @staticmethod
  def forward(ctx, spec, x, rgb_row_bias, *leaves):
    paths, trunk_depth, skips = spec
    params = unflatten_tree(paths, leaves)
    alpha, rgb = nerf_mlp_forward(x, rgb_row_bias, params,
                                  trunk_depth=trunk_depth, skips=skips)
    ctx.spec = spec
    ctx.save_for_backward(x, rgb_row_bias, *leaves)
    return alpha, rgb

  @staticmethod
  def backward(ctx, g_alpha, g_rgb):
    paths, trunk_depth, skips = ctx.spec
    x, rgb_row_bias, *leaves = ctx.saved_tensors
    params = unflatten_tree(paths, leaves)
    dx, drb, dparams = nerf_mlp_backward(x, rgb_row_bias, params, g_alpha,
                                         g_rgb, trunk_depth=trunk_depth,
                                         skips=skips)
    grads = [tree_leaf(dparams, p).to(leaf.dtype)
             for p, leaf in zip(paths, leaves)]
    return (None, dx.to(x.dtype),
            None if drb is None else drb.to(rgb_row_bias.dtype), *grads)


def nerf_mlp_train(x: torch.Tensor,
                   rgb_row_bias: Optional[torch.Tensor],
                   params: dict,
                   trunk_depth: int,
                   skips: Tuple[int, ...]):
  """Differentiable fused NerfMLP forward (the training path).

  The counterpart of nerfies_tpu.ops.fused_mlp.nerf_mlp_train: the same
  contract as `nerf_mlp_forward`, with `nerf_mlp_backward` as its VJP,
  which recomputes the activations instead of saving them (only x, the row
  bias and the params are kept between the passes). Returns (alpha (N, 8),
  rgb (N, 8)) f32.
  """
  flat = flatten_tree(params)
  spec = (tuple(p for p, _ in flat), trunk_depth, tuple(skips))
  return _NerfMlpTrain.apply(spec, x, rgb_row_bias, *[t for _, t in flat])


def launch_counts() -> Dict[str, int]:
  """Kernel launches counted by each wrapper since its last reset.

  A call of a backward wrapper counts once: its row pass and its
  weight-gradient pass run per chunk of rows, as parts of one kernel.
  """
  from nerfies_tpu_torch.ops import fused_warp
  return {'nerf_mlp_forward': nerf_mlp_forward.launches,
          'warp_trunk_forward': warp_trunk_forward.launches,
          'nerf_mlp_backward': nerf_mlp_backward.launches,
          'warp_mlp_forward': fused_warp.warp_mlp_forward.launches,
          'warp_mlp_backward': fused_warp.warp_mlp_backward.launches}


def reset_launch_counts() -> None:
  """Sets every wrapper's count to 0 and forgets the cards launched on
  (_build.launch_cards)."""
  from nerfies_tpu_torch.ops import fused_warp
  _build.launch_cards(reset=True)
  nerf_mlp_forward.launches = 0
  warp_trunk_forward.launches = 0
  nerf_mlp_backward.launches = 0
  fused_warp.warp_mlp_forward.launches = 0
  fused_warp.warp_mlp_backward.launches = 0
