"""The other activations, norms and the unfused forward against the JAX
package, on the CPU: flax's LayerNorm (the channels of each pixel, eps
1e-6) and GroupNorm (32 groups, eps 1e-6) module by module in f32 and
bf16, the swish activation, and whole models with swish, layernorm
(encoder and decoders), groupnorm and `fused_inference=False` (96x128 R18
b2, f32, converted random weights, atol 1e-4 + rtol 1e-3; shared set-up:
`tests/torch_port_cases.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch_port_cases import forward_parity

from emsanet_tpu.models import layers as jax_layers
from emsanet_tpu_torch.models import layers
from emsanet_tpu_torch.weights import load_flax_variables


@pytest.mark.parametrize("overrides", [
    {"encoder_normalization": "layernorm",
     "decoder_normalization": "layernorm", "activation": "swish"},
    {"encoder_normalization": "groupnorm",
     "decoder_normalization": "groupnorm", "activation": "silu"},
    {"fused_inference": False},
], ids=["layernorm-swish", "groupnorm-silu", "unfused"])
def test_layer_setting_matches_jax(overrides):
    forward_parity(overrides)


@pytest.mark.parametrize("kind", ["layernorm", "groupnorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_matches_flax(kind, dtype):
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 5, 7, 64) * 3 + 1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    fm = jax_layers.Norm(kind, dtype=jdt)
    v = {"params": {f"{'Layer' if kind == 'layernorm' else 'Group'}"
                    f"Norm_0": {
                        "scale": rng.rand(64).astype(np.float32) + 0.5,
                        "bias": rng.randn(64).astype(np.float32)}}}
    jx = jnp.asarray(x).astype(jdt)
    want = np.asarray(fm.apply(v, jx).astype(jnp.float32))
    norm = load_flax_variables(layers.Norm(64, kind), v)
    xt = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(dtype)
    with torch.no_grad():
        got = norm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)
    # the trap: torch's own layer norm over the NCHW tensor's last axes
    wrong = torch.nn.functional.layer_norm(
        xt.float().permute(0, 3, 1, 2), (5, 7)).permute(0, 2, 3, 1)
    assert not np.allclose(wrong.numpy(), want, atol=1e-2)


def test_swish_matches_flax():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    got = layers.get_activation("swish")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fnn.swish(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    assert layers.get_activation("silu") is layers.get_activation("swish")
