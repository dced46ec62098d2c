"""The bf16 stem kernel's packed layout and the kernels' weight caches, on
the CPU.

The tensor-core stem (`csrc/stem.cu`) computes the 7x7/2 conv as a
stride-1 4x4 conv over 2x2 space-to-depth packed pixels, the layout of
the JAX package's `pack_stem_inputs` / `_pack_k4` (`emsanet_tpu/ops/
stem.py:102-134`) without their padding to 16 slots. Here, in plain
PyTorch: the packed conv equals the 7x7/2 conv at f32 (atol 1e-4: two
summation orders of ~150 products), the packed weights and input equal
the JAX package's on its first 4C slots (exactly) and its other slots
are zero, and the kernel's K steps of 16 (`stem_mma_weights`, each
against 16 contiguous elements of a row of four packed pixels) give the
same conv. The wrappers' prepared weights, folded BatchNorm and parity
taps, and the chains' stacked parameters, are built once per parameter
version (`ops/param_cache.py`).
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emsanet_tpu.ops.stem import _pack_k4, pack_stem_inputs
from emsanet_tpu_torch.models.layers import (
    NonBottleneck1D,
    _cached_chain_params,
    stack_chain_params,
)
from emsanet_tpu_torch.ops import param_cache, semantic_decode, stem
from emsanet_tpu_torch.ops.polyphase_upsample import parity_taps


def _case(seed, n, h, w, c):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    k = torch.from_numpy((rng.randn(64, c, 7, 7) * 0.1).astype(np.float32))
    return x, k


def _stem_conv(x, k):
    return F.conv2d(x.permute(0, 3, 1, 2), k, stride=2, padding=3)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("h,w", [(32, 48), (13, 17)])
def test_packed_conv_equals_stem_conv(c, h, w):
    x, k = _case(0, 2, h, w, c)
    xp = stem.pack_stem_input(x).permute(0, 3, 1, 2)
    k4 = stem.packed_stem_weights(k)  # (dy, dx, slot, f)
    got = F.conv2d(F.pad(xp, (2, 1, 2, 1)), k4.permute(3, 2, 0, 1))
    want = _stem_conv(x, k)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_packed_weights_equal_jax_pack_k4(c):
    _, k = _case(1, 1, 8, 8, c)
    k7 = k.permute(2, 3, 1, 0).numpy()  # (7, 7, C, F), the JAX layout
    want = np.asarray(_pack_k4(jnp.asarray(k7), 0, c))  # 16 slots
    got = stem.packed_stem_weights(k).numpy()
    assert got.shape == (4, 4, 4 * c, 64)
    np.testing.assert_array_equal(got, want[:, :, :4 * c])
    assert not want[:, :, 4 * c:].any()


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_packed_input_equals_jax_pack_stem_inputs(c):
    x, _ = _case(2, 2, 8, 32, c)
    want = np.asarray(pack_stem_inputs([jnp.asarray(x.numpy())]))
    want = want.reshape(2, 4, 16, 16)  # lanes -> (W/2, 16 slots)
    got = stem.pack_stem_input(x).numpy()
    np.testing.assert_array_equal(got, want[..., :4 * c])
    assert not want[..., 4 * c:].any()


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_kernel_k_steps_give_the_stem_conv(c):
    """K step kk = dy C + j of conv pixel (y, x) takes elements [16 j,
    16 j + 16) of packed row y + dy, packed pixels x .. x + 3 (padded
    coordinates), against `stem_mma_weights[kk]` (64, 16)."""
    x, k = _case(3, 1, 21, 26, c)
    xp = F.pad(stem.pack_stem_input(x), (0, 0, 2, 1, 2, 1))[0]
    wk = stem.stem_mma_weights(k).float()
    assert wk.shape == (4 * c, 64, 16)
    hc, wc = xp.shape[0] - 3, xp.shape[1] - 3
    got = torch.zeros(hc, wc, 64)
    for kk in range(4 * c):
        dy, j = divmod(kk, c)
        # rows of four packed pixels: (hc, wc, 16 C) elements
        rows = torch.cat([xp[dy:dy + hc, dx:dx + wc] for dx in range(4)], -1)
        a = rows[..., 16 * j:16 * j + 16].bfloat16().float()
        got += a @ wk[kk].t()
    want = _stem_conv(x.bfloat16().float(), k.bfloat16().float())[0]
    torch.testing.assert_close(got.permute(2, 0, 1), want, atol=1e-4,
                               rtol=0)


def _bn(seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(a) for a in (
        rng.rand(64).astype(np.float32) + 0.5,
        rng.randn(64).astype(np.float32),
        (rng.randn(64) * 0.1).astype(np.float32),
        rng.rand(64).astype(np.float32) + 0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_params_built_once_per_version(dtype):
    _, k = _case(4, 1, 8, 8, 3)
    w = torch.nn.Parameter(k)
    bn = _bn(4)
    first = stem.prepared_stem_params(w, bn, dtype)
    assert stem.prepared_stem_params(w, bn, dtype) is first
    with torch.no_grad():
        w.mul_(2.0)  # in place: the version moves
    second = stem.prepared_stem_params(w, bn, dtype)
    assert second is not first
    assert stem.prepared_stem_params(w, bn, dtype) is second
    want = (stem.stem_mma_weights(w.detach()) if dtype == torch.bfloat16
            else w.detach().permute(1, 2, 3, 0))
    assert torch.equal(second[0], want)
    bn[3].add_(1.0)  # running_var: the folded BatchNorm is rebuilt
    third = stem.prepared_stem_params(w, bn, dtype)
    assert third is not second
    scale, shift = stem.fold_bn(*bn)
    assert torch.equal(third[1], scale) and torch.equal(third[2], shift)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_taps_built_once_per_version(dtype):
    w = torch.from_numpy(np.random.RandomState(5).randn(40, 1, 3, 3)
                         .astype(np.float32))
    cpu = torch.device("cpu")
    first = semantic_decode.cached_parity_taps(w, dtype, cpu)
    # a new view of the same storage and version: no rebuild
    assert semantic_decode.cached_parity_taps(w.detach(), dtype, cpu) is first
    w.add_(1.0)
    second = semantic_decode.cached_parity_taps(w, dtype, cpu)
    assert second is not first
    assert torch.equal(second, parity_taps(w, dtype))


def test_param_cache_entry_goes_with_its_owner():
    """The entry lives on its owner, here a tensor's storage: dropping the
    tensor drops the values. The entry holds the source tensors on other
    storages (their addresses cannot be reused while it lives), and not
    the owner's own, which would keep the storage alive."""
    src, other = torch.zeros(3), torch.ones(3)
    value = torch.zeros(2)
    got = param_cache.cached(src.untyped_storage(), "t", [src, other],
                             lambda: value)
    assert got is value
    held = src.untyped_storage()._param_cache["t"][1]
    assert len(held) == 1 and held[0] is other
    alive = weakref.ref(value)
    del value, got, held
    assert alive() is not None
    del src
    gc.collect()
    assert alive() is None


def test_chain_params_cache_is_reused_and_rebuilt():
    torch.manual_seed(0)
    tail = [NonBottleneck1D(8, 8) for _ in range(2)]
    first = _cached_chain_params(tail, torch.float32)
    assert _cached_chain_params(tail, torch.float32) is first
    with torch.no_grad():
        tail[1].Conv_2.weight.mul_(2.0)  # in place: the version moves
    second = _cached_chain_params(tail, torch.float32)
    assert second is not first
    want = stack_chain_params(tail, torch.float32)
    assert sorted(second) == sorted(want)
    for key in want:
        assert torch.equal(second[key], want[key]), key
