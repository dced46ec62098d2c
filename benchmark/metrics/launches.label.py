"""Device kernels a request launches, in the traced sub-window."""


def read(ctx):
    if not ctx.requests:
        return None
    reqs = ctx.trace.spans("bench.request")
    return len(ctx.trace.launched_in(reqs)) / ctx.requests
