"""The backbones of the other model settings against the JAX package,
on the CPU, without a forward: every name's stage spec (resnet18/34/50/
101, the SE and '-d16' forms) equals `emsanet_tpu`'s; ResNet-101's and
resnet34se's flax trees load into the port's model tensor for tensor
(names and shapes, `load_flax_variables` checks); a torchvision-named
ResNet-50 file initializes both R50 encoders as the JAX package's
loader does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_tmp_files import remove_large_files

from emsanet_tpu import DataConfig, EMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models.backbone import get_backbone_spec as jax_spec
from emsanet_tpu_torch import config as port_config
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.backbone import get_backbone_spec
from emsanet_tpu_torch.models.emsanet import EMSANet
from emsanet_tpu_torch.weights import load_flax_variables


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """The checkpoints a test writes go once it is done."""
    yield
    remove_large_files(tmp_path)


NAMES = [f"{b}{se}{d}" for b in ("resnet18", "resnet34", "resnet50",
                                  "resnet101")
         for se in ("", "se") if not (se and b in ("resnet50", "resnet101"))
         for d in ("", "-d16")]


@pytest.mark.parametrize("name", NAMES)
def test_backbone_spec_matches_jax(name):
    p, j = get_backbone_spec(name), jax_spec(name)
    assert (p.stage_blocks, p.bottleneck, p.se, p.downsampling,
            p.stage_out_features, p.n_channels_out) == (
        j.stage_blocks, j.bottleneck, j.se, j.downsampling,
        j.stage_out_features, j.n_channels_out)
    assert p.skip_features((4, 8, 16)) == j.skip_features((4, 8, 16))


@pytest.mark.parametrize("backbone", ["resnet101", "resnet34se"])
def test_deep_backbone_takes_the_flax_tree(backbone):
    """Every leaf of the JAX model's tree maps onto the port's model, with
    its shape, and none is left over (`load_flax_variables` checks)."""
    kw = dict(tasks=("semantic",), input_height=64, input_width=64,
              rgb_encoder_backbone=backbone, depth_encoder_backbone=backbone)
    jcfg = EMSANetConfig(model=JaxModelConfig(**kw),
                         data=DataConfig(dataset="synthetic")).validate()
    jmodel = JaxEMSANet(cfg=jcfg.model,
                        dataset_config=jax_ds_config(jcfg.data))
    dummy = {"rgb": jnp.zeros((1, 64, 64, 3)),
             "depth": jnp.zeros((1, 64, 64, 1))}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), dummy)
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    model = EMSANet(port_config.flagship_config(enable_panoptic=False, **kw),
                    get_dataset_config("synthetic"))
    load_flax_variables(model, zeros)
    spec = get_backbone_spec(backbone)
    stages = [getattr(model.encoder, f"rgb_stage{i}") for i in range(4)]
    assert tuple(s.n_blocks for s in stages) == spec.stage_blocks


def test_load_backbone_pretrained_resnet50_matches_jax(tmp_path):
    """A torchvision-named ResNet-50 file (random tensors, the bottleneck
    names) into both encoders of an R50 model: the JAX package's loader
    gives the same tensors, and every bottleneck conv and norm is taken
    (the depth stem as conv1 summed over its RGB channels)."""
    import torch
    from test_torch_port_datasets import _same_state, _State, _to_flax

    from emsanet_tpu import weights as jax_weights
    from emsanet_tpu_torch import weights

    model = EMSANet(port_config.flagship_config(
        input_height=64, input_width=64, rgb_encoder_backbone="resnet50",
        depth_encoder_backbone="resnet50"), get_dataset_config("synthetic"))
    own = model.state_dict()
    g = torch.Generator().manual_seed(5)
    sd = {t: torch.randn(own[f"encoder.{p}"].shape, generator=g)
          for t, p in weights.resnet_torch_name_map(
              "rgb", (3, 4, 6, 3), bottleneck=True).items()
          if f"encoder.{p}" in own}  # downsample: first blocks only
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    flat_p, flat_s = _to_flax(own)
    state = _State(jax_weights._unflatten(flat_p),
                   jax_weights._unflatten(flat_s))
    for mod in ("rgb", "depth"):
        weights.load_backbone_pretrained(model, path, mod, "resnet50",
                                         verbose=False)
        state = jax_weights.load_backbone_pretrained(state, path, mod,
                                                     "resnet50",
                                                     verbose=False)
    got = model.state_dict()
    _same_state(got, weights.flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}))
    for t, p in weights.resnet_torch_name_map("depth", (3, 4, 6, 3),
                                              bottleneck=True).items():
        if t not in sd:
            continue
        want = sd[t].sum(1, keepdim=True) if t == "conv1.weight" else sd[t]
        assert torch.equal(got[f"encoder.{p}"], want), p
