"""Device: the share of the measured window's time in which no kernel, copy
or fill ran on the card. The device time a unit takes is read from the
timing stretch's trace (CUDA activity alone), where it does not depend on the
host's pace; the window's time per unit is the unprofiled window's own, so
that the profiler's cost on the host (CUPTI's records, some 10 us a launch)
does not read as idle time. Here the units are frames."""


def read(ctx):
  trace = None if ctx.trace is None else ctx.trace.timing
  if (trace is None or not trace.ops or not trace.units
      or not ctx.window.units or ctx.window.seconds <= 0):
    return None
  busy = trace.busy_s / trace.units * ctx.window.units
  return 100.0 * (1.0 - busy / ctx.window.seconds)
