"""Kernels: the NeRF MLP backward's row and weight passes
(csrc/fused_mlp_bwd.cu, csrc/weight_grad.cu) in the profiled steps, as a
share of their roofline. Bound: compute (counts.nerf_backward_least_s, dX
and dW products of both levels' samples at the dense bf16 peak). The
weight-pass kernels also serve the warp's backward, so only launches made
inside the NeRF MLP's autograd backward count: they are read from the
attributed stretch, the one that records host ops."""

from benchmark import counts

KERNELS = ('nerf_bwd_rows_kernel', 'dw_partial_kernel', 'dw_reduce_kernel')
INSIDE = 'NerfMlpTrainBackward'


def read(ctx):
  if ctx.trace is None or counts.peak(ctx.device_name) is None:
    return None
  trace = ctx.trace.attributed
  measured = trace.device_s(KERNELS, inside=INSIDE)
  if measured <= 0:
    return None
  batch = ctx.cell.config['train']['batch_size']
  coarse = ctx.model['num_coarse_samples']
  fine = coarse + ctx.model['num_fine_samples']
  least = sum(counts.nerf_backward_least_s(ctx.model, batch * s,
                                           ctx.device_name)[0]
              for s in (coarse, fine))
  return 100.0 * least * trace.units / measured
