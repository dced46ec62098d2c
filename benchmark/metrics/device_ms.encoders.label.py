"""Device ms a request spends in the encoders: device prep and every
kernel launched inside the model's encoder, traced sub-window."""

from harness.layers import request_parts


def read(ctx):
    if not ctx.requests:
        return None
    p = request_parts(ctx.trace)
    return ctx.trace.device_us(p["prep"] + p["encoder"]) / 1e3 / ctx.requests
