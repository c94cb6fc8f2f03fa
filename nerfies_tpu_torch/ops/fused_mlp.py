"""The NeRF MLP and the warp trunk as fused kernels, with their plain versions.

Port of the two serving kernels of nerfies_tpu/ops/fused_mlp.py:
`nerf_mlp_forward` (:78) and `warp_trunk_forward` (:645), with the same
arguments and output contracts. On a CUDA tensor each wrapper launches its
hand-written kernel from csrc/fused_mlp.cu (built by ops/_build.py) and
counts the launch in its `launches` attribute; on a CPU tensor it runs the
plain PyTorch version (`nerf_mlp_reference`, `warp_trunk_reference`). It
never falls back from one to the other.

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
heads to 8, which is the width of the outputs.
"""

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerfies_tpu_torch.ops import _build

# Shapes the kernels are built for (csrc/fused_mlp.cu): input columns are
# padded to _PE_PAD, heads to _HEAD_PAD; at most _MAX_DEPTH layers.
_PE_PAD = 64
_HEAD_PAD = 16
_MAX_DEPTH = 16
_NERF_WIDTHS = ((256, 128),)  # (trunk width, rgb branch width)
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


def _launch_nerf(x, rgb_row_bias, ops: NerfOperands, trunk_depth, skips):
  name = 'nerf_mlp_forward'
  _check_rows(x, name)
  if (ops.width, ops.rgb_width) not in _NERF_WIDTHS:
    raise ValueError(f'{name}: kernel built for (width, rgb width) in '
                     f'{_NERF_WIDTHS}, got {(ops.width, ops.rgb_width)}')
  if not 1 <= trunk_depth <= _MAX_DEPTH:
    raise ValueError(f'{name}: trunk depth must be in [1, {_MAX_DEPTH}]')
  n, c_in = x.shape
  x = x.float().contiguous()
  if ops.rgb_hidden is None or rgb_row_bias is None:
    rgb_row_bias = None
  else:
    rgb_row_bias = _check_row_bias(rgb_row_bias, x, ops.rgb_width, name)

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
      ops.width, ops.rgb_width, x.device.index or 0,
      torch.cuda.current_stream(x.device).cuda_stream)
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
      x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
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


def launch_counts() -> Dict[str, int]:
  """Kernel launches counted by each wrapper since its last reset."""
  return {'nerf_mlp_forward': nerf_mlp_forward.launches,
          'warp_trunk_forward': warp_trunk_forward.launches}


def reset_launch_counts() -> None:
  nerf_mlp_forward.launches = 0
  warp_trunk_forward.launches = 0
