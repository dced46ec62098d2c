"""Where the bf16 NBt1D pair backward's gu differs from its plain version
by more than the card's bound, and whether ReLU mask flips of the first
conv account for it. Needs the card:

    python tests/torch_pair_flips.py [--seeds 14 15] [--repeat 2]

For each seed, shape and mode it prints gu's error relative to its max,
the pixels with an element beyond 5e-2 of the max, the flips found by
`relu_flips` (tests/test_torch_cuda_kernels.py) with each fitted delta,
its pre-activation z (float64) and the f32 rounding bound on z, and the
error left once they are accounted for. The kernel runs --repeat times on
the same inputs; the script fails if any repeat differs in a bit.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from emsanet_tpu_torch.ops import nbt1d_train  # noqa: E402
from test_torch_cuda_kernels import (  # noqa: E402
    MANY_TILE_SHAPES,
    _pair_case,
    _rel,
    relu_flips,
)

TOL = 5e-2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[14, 15])
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        for shape in MANY_TILE_SHAPES:
            for mode in ("plain", "affine"):
                u, s, t, w31, b31, w13, b13, gy, gsums = _pair_case(
                    seed, shape, torch.bfloat16)
                pa = (mode, u, s, t, w31, b31, w13, b13)
                want = nbt1d_train.pair_bwd_plain(*pa, gy, gsums)[0]
                runs = [nbt1d_train.pair_bwd(*pa, gy, gsums)[0]
                        for _ in range(args.repeat)]
                if any(not torch.equal(r, runs[0]) for r in runs[1:]):
                    print(f"seed {seed} {shape} {mode}: repeats differ",
                          file=sys.stderr)
                    return 1
                gu = runs[0]
                err = (gu.float() - want.float()).abs()
                top = want.float().abs().max()
                pixels = (err > TOL * top).any(-1).nonzero().tolist()
                flips, left = relu_flips(mode, u, s, t, w31, b31, gu, want,
                                         TOL)
                print(json.dumps({
                    "seed": seed, "shape": list(shape), "mode": mode,
                    "repeats_equal": args.repeat,
                    "gu_rel": _rel(gu, want),
                    "beyond": int((err > TOL * top).sum()),
                    "pixels": pixels,
                    "flips": [dict(zip(("n", "c", "h", "w", "delta", "z",
                                        "z_bound"), f)) for f in flips],
                    "left": left}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
