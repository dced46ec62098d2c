"""The train kernels' plain versions (emsanet_tpu_torch/ops/nbt1d_train.py,
ops/semantic_train_head.py) against the JAX package's Pallas kernels.

The same numpy inputs go to the Pallas kernels in interpret mode (as
tests/test_nbt1d_train.py and tests/test_train_head.py run them) and to
the port's plain versions, which the CUDA kernels are held against on
the card (tests/test_torch_cuda_kernels.py). f32 on the CPU.

Tolerances: relative to each output's largest magnitude, 1e-5 for the
pair's y, sums and gradients and the head loss's gradients, rtol 1e-5
for the loss (summation order only; measured <= 1e-6). The f64 checks
hold the pair path against the unfused ops to 1e-10, except the biases
that feed a BatchNorm, whose gradient is zero up to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emsanet_tpu.ops import nbt1d_train as jax_pair
from emsanet_tpu.ops.semantic_train_head import _fused_loss
from emsanet_tpu_torch.models import layers
from emsanet_tpu_torch.ops import nbt1d_train, semantic_train_head
from emsanet_tpu_torch.ops.polyphase_upsample import parity_taps

NAMES = ("u", "s", "t", "w31", "b31", "w13", "b13")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair_inputs(seed, shape):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    f = np.float32
    return dict(
        u=rng.randn(*shape).astype(f), s=(rng.rand(c) + 0.5).astype(f),
        t=(rng.randn(c) * 0.1).astype(f),
        w31=(rng.randn(3, c, c) * 0.1).astype(f),
        b31=(rng.randn(c) * 0.1).astype(f),
        w13=(rng.randn(3, c, c) * 0.1).astype(f),
        b13=(rng.randn(c) * 0.1).astype(f),
        gy=rng.randn(*shape).astype(f),
        gsums=(rng.randn(2, c) * 0.1).astype(f))


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("variant", ["padded", "clamped"])
@pytest.mark.parametrize("mode", ["plain", "affine"])
def test_pair_plain_matches_pallas(mode, variant, c):
    """Forward, sums and all seven gradients; `padded` (one tile, the
    rows padded in XLA) and `clamped` (tile_h=8 over 32 rows: the
    edge-tile realignment)."""
    shape, tile = ((2, 16, 16, c), None) if variant == "padded" else (
        (1, 32, 16, c), 8)
    p = _pair_inputs(c + len(mode), shape)
    args = [p[k] for k in NAMES]
    y, sums = jax_pair._pair_fwd(*args, mode=mode, interpret=True,
                                 tile_h=tile)
    jg = jax_pair._pair_bwd(*args, p["gy"], p["gsums"], mode=mode,
                            interpret=True, tile_h=tile)
    targs = [_t(a) for a in args]
    py, psums = nbt1d_train.pair_fwd_plain(mode, *targs)
    assert _rel(py.numpy(), y) <= 1e-5
    assert _rel(psums.numpy(), sums) <= 1e-5
    pg = nbt1d_train.pair_bwd_plain(mode, *targs, _t(p["gy"]),
                                    _t(p["gsums"]))
    for name, want, got in zip(NAMES, jg, pg):
        if mode == "plain" and name in ("s", "t"):
            assert float(got.abs().max()) == 0.0
            continue
        assert _rel(got.numpy(), want) <= 1e-5, name


def _unfused_pair(mode, u, s, t, w31, b31, w13, b13):
    """The pair as separate ops, written independently of the port."""
    x = u.permute(0, 3, 1, 2)
    if mode == "affine":
        x = F.relu(x * s[:, None, None] + t[:, None, None])
    x = F.pad(x, (0, 0, 1, 1))
    a = sum(torch.einsum("nchw,co->nohw", x[:, :, d:d + u.shape[1]], w31[d])
            for d in range(3)) + b31[:, None, None]
    a = F.pad(F.relu(a), (1, 1))
    y = sum(torch.einsum("nchw,co->nohw", a[..., d:d + u.shape[2]], w13[d])
            for d in range(3)) + b13[:, None, None]
    return y.permute(0, 2, 3, 1), torch.stack([y.sum((0, 2, 3)),
                                               (y * y).sum((0, 2, 3))])


@pytest.mark.parametrize("mode", ["plain", "affine"])
def test_pair_plain_backward_exact_f64(mode):
    """f64: the plain backward against torch autograd of the unfused ops."""
    p = _pair_inputs(5, (2, 8, 12, 64))
    args = [_t(p[k]).double() for k in NAMES]
    gy, gsums = _t(p["gy"]).double(), _t(p["gsums"]).double()
    got = nbt1d_train.pair_bwd_plain(mode, *args, gy, gsums)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, sums = _unfused_pair(mode, *leaves)
    want = torch.autograd.grad((y, sums), leaves, (gy, gsums),
                               allow_unused=True)
    for name, g, w in zip(NAMES, got, want):
        if w is None:  # s, t in 'plain'
            assert float(g.abs().max()) == 0.0
            continue
        assert _rel(g.numpy(), w.numpy()) <= 1e-10, name


@pytest.mark.parametrize("zero_init", [False, True])
def test_chain_train_exact_f64(zero_init):
    """f64: two NBt1D blocks in train mode through the pairs
    (`apply_blocks_fused` with fused_train) against the same blocks
    unfused: output, every gradient and the running statistics."""
    torch.manual_seed(0)
    blocks = [layers.NonBottleneck1D(64, 64, 1, zero_init)
              for _ in range(2)]
    with torch.no_grad():
        for m in (m for b in blocks for m in b.modules()):
            if isinstance(m, layers.BatchNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
            elif isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0, 0.1)
    for b in blocks:
        b.double().train()
    x = torch.randn(2, 64, 8, 16, dtype=torch.float64)
    cot = torch.randn_like(x)

    def run(fused):
        xx = x.clone().requires_grad_(True)
        state = [{k: v.clone() for k, v in b.state_dict().items()}
                 for b in blocks]
        for b in blocks:
            b.zero_grad()
        y = layers.apply_blocks_fused(blocks, xx, fused)
        (y * cot).sum().backward()
        grads = {f"{i}.{k}": p.grad.clone() for i, b in enumerate(blocks)
                 for k, p in b.named_parameters()}
        stats = [{k: v.clone() for k, v in b.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))}
                 for b in blocks]
        for b, s in zip(blocks, state):
            b.load_state_dict(s)
        return y.detach(), xx.grad, grads, stats

    old = nbt1d_train.MIN_PIXELS
    nbt1d_train.MIN_PIXELS = 0
    try:
        y0, gx0, g0, s0 = run(False)
        y1, gx1, g1, s1 = run(True)
    finally:
        nbt1d_train.MIN_PIXELS = old
    assert _rel(y1.numpy(), y0.numpy()) <= 1e-10
    assert _rel(gx1.numpy(), gx0.numpy()) <= 1e-10
    for k in g0:
        if k.endswith(("Conv_1.bias", "Conv_3.bias")):
            continue  # feeds a BatchNorm: zero gradient up to rounding
        assert _rel(g1[k].numpy(), g0[k].numpy()) <= 1e-10, k
    for a, b in zip(s1, s0):
        for k in a:
            assert _rel(a[k].numpy(), b[k].numpy()) <= 1e-12, k


def test_chain_train_matches_pallas_chain():
    """The port's chain_train (its C=64 pairs directly) against the JAX
    package's (whose C=64 chain runs as a pixel-pair-merged C=128 one)."""
    k, c = 2, 64
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 16, c).astype(np.float32)
    stacked = {
        "w31": rng.randn(k, 2, 3, c, c) * 0.1,
        "w13": rng.randn(k, 2, 3, c, c) * 0.1,
        "b31": rng.randn(k, 2, c) * 0.1, "b13": rng.randn(k, 2, c) * 0.1,
        "gamma": rng.rand(k, 2, c) + 0.5, "beta": rng.randn(k, 2, c) * 0.1,
    }
    stacked = {key: v.astype(np.float32) for key, v in stacked.items()}
    want = jax_pair.chain_train(jnp.asarray(x), {
        key: jnp.asarray(v) for key, v in stacked.items()}, interpret=True)
    got = nbt1d_train.chain_train(_t(x), {key: _t(v)
                                          for key, v in stacked.items()})
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5


def test_pairs_gate_matches_jax():
    for h, w, c in [(120, 160, 64), (60, 80, 128), (8, 2048, 64),
                    (120, 160, 256), (240, 320, 256), (120, 150, 64),
                    (7, 4096, 128), (30, 40, 512)]:
        assert nbt1d_train.pairs_supported(h, w, c) == (
            jax_pair.pairs_supported(h, w, c)), (h, w, c)
    assert nbt1d_train.MIN_PIXELS == jax_pair.MIN_PIXELS


def _loss_case(seed, n, h2, w2, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h2, w2, c).astype(np.float32)
    k = (rng.randn(3, 3, 1, c) * 0.3 + 0.1).astype(np.float32)
    tgt = rng.randint(0, c + 1, (n, 2 * h2, 2 * w2))
    tgt = np.where(rng.rand(*tgt.shape) < 0.2, 0, tgt).astype(np.int32)
    cw = (rng.rand(c) + 0.5).astype(np.float32)
    return x, k, tgt, cw


@pytest.mark.parametrize("shape", [(2, 12, 16, 8), (1, 24, 16, 5)])
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_head_loss_plain_matches_pallas(shape, ls):
    """Value and gradients of the plain version against the Pallas
    kernel (interpret), with class weights, label smoothing and void."""
    x, k, tgt, cw = _loss_case(len(shape) + int(ls * 10), *shape)
    args = (jnp.asarray(x), jnp.asarray(k))

    def jloss(x, k):
        return _fused_loss(ls, True, x, k, jnp.asarray(tgt), jnp.asarray(cw))

    want = float(jloss(*args))
    jgx, jgk = jax.grad(jloss, argnums=(0, 1))(*args)
    xt = _t(x).requires_grad_(True)
    wt = _t(k.transpose(3, 2, 0, 1)).requires_grad_(True)
    got = semantic_train_head.fused_semantic_head_loss(
        xt, wt, _t(tgt), _t(cw), ls)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    assert _rel(xt.grad.numpy(), jgx) <= 1e-5
    assert _rel(wt.grad.numpy().transpose(2, 3, 1, 0), jgk) <= 1e-5


def test_head_loss_sums_and_backward_plain():
    """The kernels' plain contracts: (sum w nll, sum w), and the backward
    scaled by gscale = cotangent / sum w, against the loss's autograd."""
    x, k, tgt, cw = _loss_case(3, 2, 12, 16, 8)
    xt, wt = _t(x), _t(k.transpose(3, 2, 0, 1))
    s, w = semantic_train_head.head_loss_fwd_plain(xt, wt, _t(tgt), _t(cw),
                                                   0.1)
    xl, wl = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    loss = semantic_train_head.semantic_head_loss_reference(
        xl, wl, _t(tgt), _t(cw), 0.1)
    (loss * 0.7).backward()
    np.testing.assert_allclose(float(s / w), float(loss.detach()), rtol=1e-6)
    dx, dw = semantic_train_head.head_loss_bwd_plain(
        xt, wt, _t(tgt), _t(cw), 0.1, torch.tensor([0.7]) / w)
    assert _rel(dx.numpy(), xl.grad.numpy()) <= 1e-6
    assert _rel(dw.numpy(), wl.grad.numpy()) <= 1e-6


def test_taps_gradient_maps_back_to_the_3x3_weight():
    """`taps_grad_to_weight` (the CUDA backward's last step) is the
    adjoint of `parity_taps`: it equals autograd through it."""
    rng = np.random.RandomState(4)
    w = _t(rng.randn(7, 1, 3, 3).astype(np.float32)).requires_grad_(True)
    taps = parity_taps(w, torch.float32)
    g = torch.from_numpy(rng.randn(*taps.shape).astype(np.float32))
    (taps * g).sum().backward()
    got = semantic_train_head.taps_grad_to_weight(g)
    assert _rel(got.numpy(), w.grad.numpy()) <= 1e-6


@pytest.mark.parametrize("mode", ["plain", "affine"])
def test_pair_bf16_backward_rounding_within_card_bound(mode):
    """bf16: the Pallas pair backward (interpret mode), which rounds dy and
    da to bf16 before its matrix unit, against the port's bf16 plain
    version, which keeps them f32. Every gradient agrees to within 5e-2 of
    its largest magnitude, the bound the card's bf16 kernel (which rounds
    as the TPU kernel does) is held to against the plain version
    (chip_smoke.py, tests/test_torch_cuda_kernels.py); measured <= 5.3e-3."""
    shape = (2, 16, 32, 64)
    p = _pair_inputs(21 + len(mode), shape)
    rep = {k: np.asarray(jnp.asarray(p[k], jnp.bfloat16), np.float32)
           for k in ("u", "w31", "w13", "gy")}  # bf16-representable
    jb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in rep.items()}
    jg = jax_pair._pair_bwd(jb["u"], p["s"], p["t"], jb["w31"], p["b31"],
                            jb["w13"], p["b13"], jb["gy"], p["gsums"],
                            mode=mode, interpret=True)
    pg = nbt1d_train.pair_bwd_plain(
        mode, _t(rep["u"]).bfloat16(), _t(p["s"]), _t(p["t"]),
        _t(rep["w31"]), _t(p["b31"]), _t(rep["w13"]), _t(p["b13"]),
        _t(rep["gy"]).bfloat16(), _t(p["gsums"]))
    for name, want, got in zip(NAMES, jg, pg):
        if mode == "plain" and name in ("s", "t"):
            assert float(got.abs().max()) == 0.0
            continue
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) \
            <= 5e-2, name
