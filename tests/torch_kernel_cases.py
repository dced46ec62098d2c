"""Inputs of the pixel -> center grouping (`group_pixels_argmin`), of
the plane interleave (`interleave_planes`) and of the segment lookup
(`segment_lookup`, `LOOKUP_CASES`): the grouping's edge cases
for its CPU tests (`test_torch_port_kernels.py`) and card tests
(`test_torch_cuda_kernels.py`), and the frame-size cases of both kernels
for the card tests and `emsanet_tpu_torch/kernel_bench.py` (not
collected by pytest).

The grouping builders return (voted (N, P, 2) f32, centers (N, K, 2)
f32, valid (N, K) bool) as numpy arrays made from a seed. Coordinates are whole
numbers, so distances are exact and tie between centers. In the edge
cases every invalid center lies within 64 pixels of every vote: the JAX
Pallas kernel scores an invalid center as its distance + 1e12, which
rounds to 1e12 (the reference's value) only below half an f32 ulp of 1e12
(32768).
"""

import numpy as np

H, W = 480, 640  # the flagship's frame
K = 64           # instance_center_heatmap_top_k
EDGE_CASES = ("all-invalid", "one-valid-first", "one-valid-last",
              "scattered", "far-behind-invalid", "k1", "k1-invalid",
              "k65", "p-ragged", "p-tail")


def _near(rng, n, p, k):
    voted = rng.randint(-4, 60, (n, p, 2)).astype(np.float32)
    centers = rng.randint(0, 64, (n, k, 2)).astype(np.float32)
    return voted, centers


def _far(rng, n, p):
    """Valid centers at a distance >= 1e12 (and at f32(1e12) exactly from
    a vote at the origin), invalid ones next to every vote, in both
    orders."""
    voted = rng.randint(-4, 5, (n, p, 2)).astype(np.float32)
    voted[:, :4] = 0.0  # on the exact tie
    centers = np.zeros((n, 6, 2), np.float32)
    valid = np.zeros((n, 6), bool)
    # image 0: invalid, (1e6, 0), (2e6, 0), invalid, (1e6, 0), invalid
    centers[0, :, 0] = [1, 1e6, 2e6, -2, 1e6, 0]
    valid[0] = [False, True, True, False, True, False]
    # image 1: (1e6, 0) ahead of the invalid centers, then (3e6, 0)
    centers[1 % n, :, 0] = [1e6, 2, 3e6, -1, 1e6, 1]
    valid[1 % n] = [True, False, True, False, True, False]
    return voted, centers, valid


def edge_case(name, n=2):
    """One named edge case (`EDGE_CASES`), K = 64 unless it says otherwise,
    P = 1030 (not a multiple of 4) unless it says otherwise."""
    rng = np.random.RandomState(EDGE_CASES.index(name))
    p = 2052 if name == "p-tail" else 1030
    k = {"k1": 1, "k1-invalid": 1, "k65": 65}.get(name, K)
    if name == "far-behind-invalid":
        return _far(rng, n, p)
    voted, centers = _near(rng, n, p, k)
    valid = np.zeros((n, k), bool)
    if name == "one-valid-first":
        valid[:, 0] = True
    elif name == "one-valid-last":
        valid[:, k - 1] = True
    elif name == "k1":
        valid[:] = True
    elif name != "all-invalid" and name != "k1-invalid":
        valid = rng.rand(n, k) > 0.5
        valid[:, 0] = False  # never a prefix of K
        valid[:, 1] = True
    return voted, centers, valid


def frame_votes(seed, n, h=H, w=W):
    """(N, H W, 2) votes of a frame in the parity planes' pixel order: each
    pixel's position plus an offset of up to 20 pixels."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    loc = np.stack([ys, xs], -1).astype(np.float32)
    loc = loc.reshape(h // 2, 2, w // 2, 2, 2).transpose(1, 3, 0, 2, 4)
    loc = loc.reshape(1, h * w, 2)
    off = rng.uniform(-20, 20, (n, h * w, 2)).astype(np.float32)
    return loc + off


def center_set(seed, n, n_valid, k=K, h=H, w=W):
    """(centers (N, K, 2), valid (N, K)): K centers anywhere in the frame,
    n_valid of them valid, spread over the K slots."""
    rng = np.random.RandomState(seed)
    centers = np.stack([rng.randint(0, h, (n, k)), rng.randint(0, w, (n, k))],
                       -1).astype(np.float32)
    valid = np.zeros((n, k), bool)
    for b in range(n):
        valid[b, rng.permutation(k)[:n_valid]] = True
    return centers, valid


def frame_planes(seed, shape):
    """The decode-planes frame's maps as `interleave_planes` gets them,
    parity planes of `shape` (N, 4, H/2, W/2): four int32 maps (semantic
    class, instance, panoptic id and class), two f32 scores and the bool
    instance foreground. numpy arrays."""
    rng = np.random.RandomState(seed)
    named = {key: rng.randint(-2**31, 2**31 - 1, shape).astype(np.int32)
             for key in ("semantic_idx", "instance", "panoptic",
                         "panoptic_semantic")}
    for key in ("semantic_score", "panoptic_score"):
        named[key] = rng.randn(*shape).astype(np.float32)
    named["foreground"] = rng.rand(*shape) > 0.5
    return named


# (N, P, D, S, misaligned): the segment lookup's cases; keys run from
# below 0 to past S, with int32's extremes in the first few pixels.
# misaligned: the keys start 4 bytes past a 16-byte boundary (the
# kernel's scalar path, as P % 4 != 0 takes it)
LOOKUP_CASES = {
    "frame b1": (1, H * W, 2, K + 1, False),
    "frame b8": (8, H * W, 2, K + 1, False),
    "d1": (2, 4096, 1, K + 1, False),
    "d3": (2, 4096, 3, K + 1, False),
    "p-ragged d1": (3, 4097, 1, K + 1, False),
    "p-ragged d2": (3, 4097, 2, K + 1, False),
    "p-ragged d3": (2, 1023, 3, K + 1, False),
    "misaligned": (2, 4096, 2, K + 1, True),
    "large table": (2, 8192, 3, 5000, False),  # 60 kB: above 48 kB
}


def lookup_case(name, seed=0):
    """(keys (N, P) int32, tables (N, D, S) f32, misaligned) of a
    LOOKUP_CASES entry; numpy arrays."""
    n, p, d, s, misaligned = LOOKUP_CASES[name]
    rng = np.random.RandomState(seed)
    keys = rng.randint(-3, s + 3, (n, p)).astype(np.int32)
    keys[:, :4] = (-2**31, 2**31 - 1, -1, s)
    tables = rng.randn(n, d, s).astype(np.float32)
    return keys, tables, misaligned
