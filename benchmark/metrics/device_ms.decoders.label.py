"""Device ms a request spends in the context module, the decoders and
the scene head: the model's kernels outside its encoder, traced
sub-window."""

from harness.layers import request_parts


def read(ctx):
    if not ctx.requests:
        return None
    p = request_parts(ctx.trace)
    return ctx.trace.device_us(p["decoders"]) / 1e3 / ctx.requests
