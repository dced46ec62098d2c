"""Whole-model forward parity, port against JAX, for the decoders of the
other model settings: the normal task alone (its dense modules), the
segformermlp decoder of every dense task and mixed with dense ones,
basic-block and bottleneck decoder blocks, and the five-task model
whose three dense decoders' trunks run as one decoder-trunk call (the
port's decoder_megakernel='on', D = 3, the trunk's plain version on the
CPU) against the JAX model's own decoders (the same function in f32). 96x128 R18 b2, f32 CPU; converted random weights; atol 1e-4 +
rtol 1e-3. Shared set-up: `tests/torch_port_cases.py`."""

import pytest
from torch_port_cases import TASKS, forward_parity

from emsanet_tpu_torch.models import emsanet as port_emsanet

FIVE = TASKS + ("normal",)


@pytest.mark.parametrize("overrides", [
    {"tasks": ("normal",), "enable_panoptic": False},
    {"tasks": FIVE, "semantic_decoder": "segformermlp",
     "instance_decoder": "segformermlp", "normal_decoder": "segformermlp"},
    {"tasks": FIVE, "semantic_decoder": "segformermlp",
     "normal_decoder": "segformermlp"},
    {"tasks": ("semantic", "instance", "normal"), "enable_panoptic": False,
     "semantic_decoder_block": "basicblock",
     "normal_decoder_block": "bottleneck"},
], ids=["normal-only", "mlp-every-task", "mlp-mixed-with-dense",
        "basicblock-and-bottleneck-blocks"])
def test_decoder_setting_matches_jax(overrides):
    forward_parity(overrides)


def test_five_task_trunk_d3_matches_jax(monkeypatch):
    """The five-task model (the dense normal decoder beside the others):
    the port's 'on' runs one trunk call over the three dense decoders
    (semantic, instance, normal), which equals the JAX model's decoders."""
    calls = []
    trunk = port_emsanet.trunk_ops.decoder_trunk

    def counted(con_out, skips, per_module):
        calls.append(int(per_module[0]["cin_w"].shape[0]))
        return trunk(con_out, skips, per_module)

    monkeypatch.setattr(port_emsanet.trunk_ops, "decoder_trunk", counted)
    forward_parity({"tasks": FIVE}, port_overrides={
        "decoder_megakernel": "on"})
    assert calls == [3]
