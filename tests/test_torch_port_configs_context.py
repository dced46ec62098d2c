"""Whole-model forward parity, port against JAX, for the context
module's and the prediction's non-default settings, and the `decode`
head mode (96x128 R18 b2; f32 CPU; converted random weights; atol 1e-4
+ rtol 1e-3). Shared set-up: `tests/torch_port_cases.py`."""

import pytest
from torch_port_cases import forward_parity


@pytest.mark.parametrize("overrides", [
    {"context_module": "ppm-1-2-4-8"},
    {"context_module": "appm"},
    {"upsampling_context_module": "nearest"},
    {"upsampling_prediction": "bilinear"},
    {"head_decode_fusion": "decode"},
], ids=["ppm-1-2-4-8", "appm", "context-nearest", "prediction-bilinear",
        "decode"])
def test_context_setting_matches_jax(overrides):
    forward_parity(overrides)
