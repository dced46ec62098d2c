"""Share of the traced sub-window in which the card runs nothing, %: one
less the union of its kernels, memcpys and memsets over the window's
length (the result's `busy_s` over `window_s`). The window opens with the
loop's places already filled, so it is the loop's steady state; the
profiler's host overhead, which slows the enqueue of every op, is in
it."""


def read(ctx):
    a, b = ctx.trace.window()
    if b <= a:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / (b - a))
