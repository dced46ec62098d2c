"""Key maps for the panoptic merge's segment histogram: the inputs of
the histogram's card tests (`test_torch_cuda_kernels.py`), its CPU tests
(`test_torch_segment_hist.py`) and `emsanet_tpu_torch/kernel_bench.py`
(not collected by pytest).

Each builder returns (inst, sem, weights, vectors) for N images
flattened to (N, P): int32 keys and classes, f32 0/1 votes and f32
vectors (N, P, D), made with numpy from a seed.
"""

import numpy as np

S, C = 65, 41  # the flagship's segments (top-k 64 + none) and classes
H, W = 480, 640


def _vectors(rng, angle, d):
    """Unit orientation vectors (sin, cos) for D = 2; other D: the angle's
    sin, cos, then N(0, 1) components, D of them."""
    parts = [np.sin(angle), np.cos(angle)]
    parts += [rng.randn(*angle.shape) for _ in range(max(0, d - 2))]
    return np.stack(parts[:d], -1).astype(np.float32)


def parity_major(a, h, w):
    """(N, H, W, ...) -> (N, 4 H/2 W/2, ...): the parity planes' flat
    order (parity p*2+q, then row, then column), as the plane modes of
    the postprocessing give it."""
    n = a.shape[0]
    rest = a.shape[3:]
    planes = a.reshape(n, h // 2, 2, w // 2, 2, *rest)
    planes = planes.transpose(0, 2, 4, 1, 3, *range(5, 5 + len(rest)))
    return planes.reshape(n, h * w, *rest)


def frame_like(seed, n, h, w, s=S, c=C, d=2, order="row"):
    """A panoptic merge's inputs as a frame gives them: ~80% of the pixels
    in segment 0 (no instance) with non-zero vectors over regions of 40 x
    40 pixels of background classes (below C/2); coherent rectangular
    instances of thing classes, each with its own orientation; a few keys
    -1 and S, classes -1 and C, and classes 0 and C - 1 present. Votes are
    1 on thing classes (C/2 and up)."""
    rng = np.random.RandomState(seed)
    inst = np.zeros((n, h, w), np.int32)
    sem = np.zeros((n, h, w), np.int32)
    angle = rng.uniform(-np.pi, np.pi, (n, h, w))
    for b in range(n):
        grid = rng.randint(0, c // 2, (-(-h // 40), -(-w // 40)))
        sem[b] = np.kron(grid, np.ones((40, 40), np.int32))[:h, :w]
        covered = 0
        for k in range(1, s):
            if covered >= 0.2 * h * w:
                break
            rh = rng.randint(max(1, h // 12), max(2, h // 5))
            rw = rng.randint(max(1, w // 12), max(2, w // 5))
            y0, x0 = rng.randint(0, h - rh + 1), rng.randint(0, w - rw + 1)
            region = (slice(y0, y0 + rh), slice(x0, x0 + rw))
            covered += int((inst[b][region] == 0).sum())
            inst[b][region] = k
            sem[b][region] = rng.randint(c // 2, c)
            angle[b][region] = rng.uniform(-np.pi, np.pi) + 0.05 * rng.randn(
                rh, rw)
    sem[:, 0, :3] = (0, c - 1, 0)
    for flat, bad in ((inst.reshape(n, -1), (-1, s)),
                      (sem.reshape(n, -1), (-1, c))):
        for value in bad:
            idx = rng.randint(0, h * w, (n, max(1, h * w // 2000)))
            np.put_along_axis(flat, idx, value, axis=1)
    weights = (sem >= c // 2).astype(np.float32)
    vectors = _vectors(rng, angle, d)
    if order == "parity":
        return (parity_major(inst, h, w), parity_major(sem, h, w),
                parity_major(weights, h, w), parity_major(vectors, h, w))
    return (inst.reshape(n, -1), sem.reshape(n, -1), weights.reshape(n, -1),
            vectors.reshape(n, h * w, d))


def one_key(seed, n, p, d=2, key=0, cls=3):
    """Every pixel in one segment and one class, votes 1."""
    rng = np.random.RandomState(seed)
    return (np.full((n, p), key, np.int32), np.full((n, p), cls, np.int32),
            np.ones((n, p), np.float32),
            _vectors(rng, rng.uniform(-np.pi, np.pi, (n, p)), d))


def uniform(seed, n, p, s=S, c=C, d=2):
    """Uniformly random keys and classes and 0/1 votes."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, s, (n, p)).astype(np.int32),
            rng.randint(0, c, (n, p)).astype(np.int32),
            (rng.rand(n, p) > 0.5).astype(np.float32),
            rng.randn(n, p, d).astype(np.float32))
