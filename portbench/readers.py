"""What the per-layer metric readers share.

A reader takes the run's context and returns its metric, or None when
the run holds nothing for it to read.  ``ctx.host`` is the untraced
window, from which host-clock metrics are read: its ``window_s``, the
driver's ``work`` counted from shapes and the benchmark's host
``spans``.  ``ctx.trace`` is the traced stretch that follows it, from
which device metrics are read: its ``window_s``, ``work``, the
program's kernel ``launches`` in it and, on the card, the trace's
``kernels``.  Shares are in percent.
"""

from __future__ import annotations

from .devtrace import busy_seconds, kernel_seconds
from .work.peaks import INT8_OPS_PER_S


def mfu(ctx, flops_key: str):
    """The untraced window's model work over its length at the INT8
    peak."""
    flops = ctx.host.work.get(flops_key)
    if not flops:
        return None
    return 100 * flops / (ctx.host.window_s * INT8_OPS_PER_S)


def roofline(ctx, bound_key: str, kernel: str, launch_key: str,
             gemms_key: str):
    """The kernel's least time over its traced device time.  The launch
    count is held three ways (the shapes counted here, the program's
    counter, the trace); a mismatch fails the run, since the share
    would then count other work or miss some."""
    trace = ctx.trace
    if trace.kernels is None or not trace.launches.get(launch_key):
        return None
    want = trace.work[gemms_key]
    seconds, traced = kernel_seconds(trace.kernels, kernel)
    if not want == trace.launches[launch_key] == traced:
        raise RuntimeError(
            f"{kernel}: {want} launches counted from the shapes, "
            f"{trace.launches[launch_key]} by the program, {traced} traced")
    return 100 * trace.work[bound_key] / seconds


def idle_share(ctx):
    """The traced stretch's share with no kernel running on the
    device."""
    if ctx.trace.kernels is None:
        return None
    return 100 * (1 - busy_seconds(ctx.trace.kernels) / ctx.trace.window_s)
