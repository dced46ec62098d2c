"""Whole-model forward parity, port against JAX, for the encoders of the
other model settings: rgb only on the reduced-downsampling resnet18-d16
(its decoders at (8, 4), since its 1/16 output has no 1/16 skip to
add), depth only on the SE backbone resnet18se, the RGBD encoder (with
'add-rgbd' skip fusions), the dual resnet18se (SE stages and SE fusion),
the bottleneck ResNet-50 (64x64 b1, semantic and scene); 96x128 R18 b2 otherwise, f32 CPU; converted random
weights; atol 1e-4 + rtol 1e-3. Shared set-up:
`tests/torch_port_cases.py`. The backbones' specs, trees and pretrained
files: `tests/test_torch_port_variants_backbones.py`."""

import pytest
from torch_port_cases import forward_parity


@pytest.mark.parametrize("overrides", [
    {"input_modalities": ("rgb",), "rgb_encoder_backbone": "resnet18-d16",
     "encoder_decoder_skip_downsamplings": (4, 8),
     "semantic_decoder_n_channels": (256, 128),
     "semantic_decoder_downsamplings": (8, 4),
     "instance_decoder_n_channels": (256, 128),
     "instance_decoder_downsamplings": (8, 4)},
    {"input_modalities": ("depth",), "depth_encoder_backbone": "resnet18se"},
    {"input_modalities": ("rgbd",),
     "semantic_encoder_decoder_fusion": "add-rgbd",
     "instance_encoder_decoder_fusion": "add-rgbd"},
    {"rgb_encoder_backbone": "resnet18se",
     "depth_encoder_backbone": "resnet18se"},
], ids=["rgb-resnet18-d16", "depth-resnet18se", "rgbd", "dual-resnet18se"])
def test_encoder_variant_matches_jax(overrides):
    forward_parity(overrides)


def test_resnet50_matches_jax():
    forward_parity({"rgb_encoder_backbone": "resnet50",
                    "depth_encoder_backbone": "resnet50",
                    "tasks": ("semantic", "scene"), "enable_panoptic": False},
                   height=64, width=64, batch=1)
