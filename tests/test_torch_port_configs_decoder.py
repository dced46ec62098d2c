"""Whole-model forward parity, port against JAX, for the decoders'
non-default settings: their upsampling, their depth and the instance
encodings (96x128 R18 b2; f32 CPU; converted random weights; atol 1e-4
+ rtol 1e-3). Shared set-up: `tests/torch_port_cases.py`."""

import pytest
from torch_port_cases import forward_parity


@pytest.mark.parametrize("overrides", [
    {"semantic_decoder_upsampling": "bilinear",
     "instance_decoder_upsampling": "bilinear"},
    {"semantic_decoder_upsampling": "nearest",
     "instance_decoder_upsampling": "nearest"},
    {"semantic_decoder_n_blocks": 1, "instance_decoder_n_blocks": 1},
    {"semantic_decoder_n_blocks": 2, "instance_decoder_n_blocks": 2},
    {"instance_center_encoding": "identity",
     "instance_offset_encoding": "identity"},
    {"instance_offset_encoding": "relative"},
], ids=["decoder-bilinear", "decoder-nearest", "1-block", "2-blocks",
        "identity-encodings", "relative-offsets"])
def test_decoder_setting_matches_jax(overrides):
    forward_parity(overrides)
