"""Whole-model forward parity, port against JAX, for the encoder's
non-default settings: the fusions, the backbones and the skips (96x128
R18 b2, except the one R34 case; f32 CPU; converted random weights;
atol 1e-4 + rtol 1e-3). Shared set-up: `tests/torch_port_cases.py`."""

import pytest
from torch_port_cases import forward_parity


@pytest.mark.parametrize("overrides", [
    {"encoder_fusion": "se-add-uni-depth"},
    {"encoder_fusion": "add-uni-rgb"},
    {"encoder_fusion": "none"},
    {"rgb_encoder_backbone_block": "basicblock",
     "depth_encoder_backbone_block": "basicblock"},
    {"rgb_encoder_backbone": "resnet34", "depth_encoder_backbone": "resnet34"},
    {"encoder_decoder_skip_downsamplings": (4, 8)},
], ids=["fusion-se-depth", "fusion-add-rgb", "fusion-none", "basicblock",
        "resnet34", "skips-4-8"])
def test_encoder_setting_matches_jax(overrides):
    forward_parity(overrides)
