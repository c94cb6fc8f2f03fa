"""Kernels: the serving NeRF MLP forward (csrc/fused_mlp.cu's
nerf_mlp_kernel) over the frames of the timing stretch, both levels, as a
share of its roofline. Bound: compute (counts.nerf_forward_least_s over
the samples the frame's pixels need; a chunk's padding rows are work no
pixel needs)."""

from benchmark import counts

KERNELS = ('nerf_mlp_kernel',)


def read(ctx):
  if ctx.trace is None or counts.peak(ctx.device_name) is None:
    return None
  trace = ctx.trace.timing
  measured = trace.device_s(KERNELS)
  if measured <= 0:
    return None
  scene = ctx.cell.config['scene']
  rays = scene['image_width'] * scene['image_height']
  coarse = ctx.model['num_coarse_samples']
  fine = coarse + ctx.model['num_fine_samples']
  least = sum(counts.nerf_forward_least_s(ctx.model, rays * s,
                                          ctx.device_name)[0]
              for s in (coarse, fine))
  return 100.0 * least * trace.units / measured
