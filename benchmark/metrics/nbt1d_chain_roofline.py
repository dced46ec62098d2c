"""The chain kernel's share of its roofline, %: over the traced
sub-window's `emsanet::nbt1d_chain` calls, the least time the card could
take (the larger of the operations over the peak rate of the input's
dtype and the bytes over the memory's rate, from each call's recorded
input shapes) over the device time of the kernels launched inside the
calls."""

from harness import kernel_spec

OP = "emsanet::nbt1d_chain"


def read(ctx):
    if ctx.peaks is None:
        return None
    calls = ctx.trace.in_window_ops(OP)
    bound_s = device_us = 0.0
    for call in calls:
        dims = call["args"]["Input Dims"]
        itemsize = kernel_spec.ITEMSIZE[call["args"]["Input type"][0]]
        ops, byts = kernel_spec.chain(dims[0], dims[1][0], itemsize)
        rate = ctx.peaks["bf16_flops" if itemsize == 2 else "f32_flops"]
        bound_s += max(ops / rate, byts / ctx.peaks["bytes_per_s"])
        device_us += ctx.trace.device_us(ctx.trace.launched_in([call]))
    if device_us <= 0:
        return None
    return 100.0 * bound_s / (device_us / 1e6)
