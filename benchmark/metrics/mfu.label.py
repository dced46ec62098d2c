"""The frame's model FLOPs (the plain reference's forward, counted per
frame) at the untraced window's frames/s, as a share of the card's bf16
peak, %."""


def read(ctx):
    if ctx.peaks is None or not ctx.stats["items_per_s"]:
        return None
    flops = ctx.flops_per_item() * ctx.stats["items_per_s"]
    return 100.0 * flops / ctx.peaks["bf16_flops"]
