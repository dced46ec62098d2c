"""Device ms a request spends in postprocessing: its kernels launched
after the model's span, traced sub-window."""

from harness.layers import request_parts


def read(ctx):
    if not ctx.requests:
        return None
    p = request_parts(ctx.trace)
    return ctx.trace.device_us(p["post"]) / 1e3 / ctx.requests
