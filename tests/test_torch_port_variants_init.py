"""The training model's initialization against the reference's, for a
configuration that covers the other modules: SE backbones (resnet18se)
with LayerNorm in the encoder, a bottleneck instance decoder, the
segformermlp semantic decoder and the dense normal decoder (whose
batchnorm blocks keep their zero-init residual scales; the LayerNorm
encoder has none). The checks and their bounds are
`tests/test_torch_port_init.py`'s: constants equal flax's, each random
tensor's pooled std within 5% (1% above 10^4 elements) of flax's over
16 draws, truncated exactly where flax's is, He-normal only in the
encoder fusion's SE layers."""

import numpy as np
import pytest
from test_torch_port_init import TRUNC_CUT, _one_thread, _random_key

from emsanet_tpu_torch.models.layers import NonBottleneck1D

# narrow one-block decoders: the init's compile and draws scale with them
VARIANT = dict(tasks=("semantic", "instance", "normal", "scene"),
               input_height=64, input_width=64,
               rgb_encoder_backbone="resnet18se",
               depth_encoder_backbone="resnet18se",
               encoder_normalization="layernorm",
               semantic_decoder="segformermlp",
               instance_decoder_block="bottleneck",
               instance_decoder_n_blocks=1,
               instance_decoder_n_channels=(128, 64, 32),
               normal_decoder_n_blocks=2,
               normal_decoder_n_channels=(128, 64, 32))


@pytest.fixture(scope="module")
def variant_inits():
    return _one_thread(VARIANT)


def test_variant_same_tensors_and_constants(variant_inits):
    flax0, port0, _, _, model = variant_inits
    assert sorted(flax0) == sorted(port0)
    constants = [k for k in flax0 if not _random_key(k)]
    assert any("LayerNorm_0" in k for k in constants)
    zero_scales = [k for k in constants if k.endswith("BatchNorm_0.weight")
                   and not flax0[k].any()]
    # the normal decoder's 3 modules x 2 NBt1D blocks; the bottleneck
    # blocks and the MLP decoder have none
    assert len(zero_scales) == sum(
        1 for m in model.modules() if isinstance(m, NonBottleneck1D)
        and m.zero_init_residual) == 6
    for k in flax0:
        assert flax0[k].shape == port0[k].shape, k
    for k in constants:
        np.testing.assert_array_equal(port0[k], flax0[k], err_msg=k)


def test_variant_random_tensors_match_flax_distribution(variant_inits):
    flax0, _, flax_pool, port_pool, _ = variant_inits
    keys = [k for k in flax0 if _random_key(k)]
    parts = ("encoder.rgb_stage0.se0", "semantic_decoder.embed",
             "instance_decoder.module0.block0.ConvNormAct_1",
             "normal_decoder.head_conv")
    assert all(any(k.startswith(p) for k in keys) for p in parts)
    he = 0
    for k in keys:
        fm, fs, fmax, n = flax_pool.stats(k)
        pm, ps, pmax, pn = port_pool.stats(k)
        assert pn == n
        tol = 0.01 if flax0[k].size > 10_000 else 0.05
        assert abs(ps / fs - 1) <= tol, (k, ps, fs)
        assert abs(pm) <= 4 * ps / np.sqrt(n), (k, pm)
        truncated = fmax <= TRUNC_CUT
        assert (pmax <= TRUNC_CUT) == truncated, (k, pmax, fmax)
        he += not truncated
    # He-normal: the encoder fusion's SE layers only, not the stages' SE
    assert he == 20
