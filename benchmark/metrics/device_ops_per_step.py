"""Tensor ops: device kernels, copies and fills in the steps of the timing
stretch (CUDA activity alone), a step."""


def read(ctx):
  trace = None if ctx.trace is None else ctx.trace.timing
  if trace is None or not trace.ops or not trace.units:
    return None
  return len(trace.ops) / trace.units
