"""Operations and bytes of the program's kernels, from their input shapes.

Frozen from `chip_smoke.py::kernel_spec` and `train_kernel_spec` (commit
795107519fd8). Operations count 2 per multiply-add; bytes count each
input read once and each output written once.
- `nbt1d_chain` (inference): K NonBottleneck1D blocks of width C over
  x (N, H, W, C), each 4 three-tap convs: 12 C^2 multiply-adds (24 C^2
  operations) a pixel and block; x read, the output written, the
  K x 4 x 3 C^2 weights read.
- the train pair (`nbt1d_pair`, two three-tap convs): forward 12 C^2
  operations (6 C^2 multiply-adds) a pixel, reading u and writing its
  output, with the 2 x 3 C^2 weights; backward 36 C^2 (the forward
  recomputed, then the data and weight gradients of both convs),
  reading three maps and the weights and writing the two float32
  weight gradients.
"""

from __future__ import annotations

from typing import Sequence, Tuple

ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "bfloat16": 2,
            "float16": 2, "float32": 4}


def chain(x_shape: Sequence[int], k: int, itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one `nbt1d_chain` call."""
    n, h, w, c = x_shape
    ops = k * 4 * 3 * c * c * 2 * n * h * w
    byts = 2 * n * h * w * c * itemsize + k * 4 * 3 * c * c * itemsize
    return ops, byts


def pair(u_shape: Sequence[int], itemsize: int, backward: bool
         ) -> Tuple[int, int]:
    """(operations, bytes) of one train pair's forward or backward."""
    n, h, w, c = u_shape
    px = n * h * w
    wbytes = 2 * 3 * c * c * itemsize
    if not backward:
        return 12 * c * c * px, 2 * px * c * itemsize + wbytes
    return 36 * c * c * px, 3 * px * c * itemsize + wbytes + 2 * 3 * c * c * 4
