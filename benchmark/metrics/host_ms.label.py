"""Host ms a request spends in the program's frame call (enqueue), mean
over the untraced window's requests."""


def read(ctx):
    ms = ctx.stats["host_ms"]
    return sum(ms) / len(ms) if ms else None
