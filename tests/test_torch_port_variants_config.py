"""The other model settings' configuration, flags, losses and helpers
against the JAX package, on the CPU (no model forward):

- `validate_for_port` accepts every value of the JAX package's registries
  (tasks, decoders, backbones with their '-d16' forms, blocks, fusions,
  activations, normalizations, modalities, `fused_inference`,
  `train_polyphase_upsampling`), applies its rules (one modality forces
  `encoder_fusion='none'`, an MLP decoder trains without side outputs)
  and builds the model; what stays refused is data parallel training and
  wandb logging;
- every model flag of the port's parser gives the ModelConfig that
  `emsanet_tpu/utils/cli.py` gives (the fields both have);
- `ModelConfig.fused_inference` defaults to False, as there;
- `l1_normal` with and without its mask, `NormalMaskGenerator` and
  `NormalTaskHelper` against the JAX package's on the same numpy inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_tmp_files import remove_large_files

from emsanet_tpu import losses as jax_losses
from emsanet_tpu import task_helper as jax_th
from emsanet_tpu.config import KNOWN_ACTIVATIONS, KNOWN_BACKBONES
from emsanet_tpu.config import KNOWN_BLOCKS, KNOWN_DECODERS
from emsanet_tpu.config import KNOWN_ENCODER_DECODER_FUSIONS
from emsanet_tpu.config import KNOWN_NORMALIZATIONS, KNOWN_TASKS
from emsanet_tpu.config import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu.config import ModelConfig as JaxModelConfig
from emsanet_tpu.preprocessing import transforms as jax_transforms
from emsanet_tpu.utils import cli as jax_cli
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import losses
from emsanet_tpu_torch import task_helper as th
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.emsanet import EMSANet
from emsanet_tpu_torch.preprocessing import transforms

SMALL = dict(input_height=64, input_width=64,
             rgb_encoder_backbone="resnet18",
             depth_encoder_backbone="resnet18",
             rgbd_encoder_backbone="resnet18")
SETTINGS = (
    [{"tasks": (t,), "enable_panoptic": False}
     for t in KNOWN_TASKS if t != "orientation"]
    + [{"tasks": ("instance", "orientation"), "enable_panoptic": False}]
    + [{f"{task}_decoder": d, "tasks": ("semantic", "instance", "normal")}
       for task in ("semantic", "instance", "normal")
       for d in KNOWN_DECODERS]
    + [{f"{m}_encoder_backbone": b + d for m in ("rgb", "depth", "rgbd")}
       for b in KNOWN_BACKBONES for d in ("", "-d16")]
    + [{f"{where}_block": b} for b in KNOWN_BLOCKS
       for where in ("rgb_encoder_backbone", "semantic_decoder")]
    + [{"semantic_encoder_decoder_fusion": f}
       for f in KNOWN_ENCODER_DECODER_FUSIONS]
    + [{"activation": a} for a in KNOWN_ACTIVATIONS]
    + [{"encoder_normalization": n, "decoder_normalization": n}
       for n in KNOWN_NORMALIZATIONS]
    + [{"input_modalities": m} for m in
       (("rgb",), ("depth",), ("rgb", "depth"), ("rgbd",))]
    + [{"fused_inference": f} for f in (True, False)]
    + [{"train_polyphase_upsampling": True}]
)


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """The checkpoints a test writes go once it is done."""
    yield
    remove_large_files(tmp_path)



@pytest.mark.parametrize("setting", SETTINGS, ids=[
    "-".join(f"{k}={'+'.join(v) if isinstance(v, tuple) else v}"
             for k, v in s.items()) for s in SETTINGS])
def test_every_registry_value_builds(setting):
    cfg = pc.EMSANetConfig(
        model=pc.ModelConfig(**{**SMALL, **setting}),
        data=pc.DataConfig(dataset="synthetic"))
    pc.validate_train_for_port(cfg)
    EMSANet(cfg.model, get_dataset_config("synthetic"), train=True)


def test_model_rules_match_jax():
    for kw in ({"input_modalities": ("depth",)},
               {"input_modalities": ("rgbd",)},
               {"semantic_decoder": "segformermlp",
                "tasks": ("semantic", "normal"),
                "normal_decoder": "segformermlp"}):
        got = pc.validate_for_port(pc.ModelConfig(**kw))
        want = JaxEMSANetConfig(model=JaxModelConfig(**kw)).validate().model
        for f in ("encoder_fusion", "semantic_no_multiscale_supervision",
                  "instance_no_multiscale_supervision",
                  "normal_no_multiscale_supervision"):
            assert getattr(got, f) == getattr(want, f), (kw, f)
        for task in ("semantic", "instance", "normal"):
            assert got.task_side_output_downscales(task) == (
                want.task_side_output_downscales(task))
        assert got.side_output_downscales == want.side_output_downscales


def test_fused_inference_defaults_off_as_in_jax():
    assert pc.ModelConfig().fused_inference is False
    assert JaxModelConfig().fused_inference is False
    cfg, _, _ = trainer.parse_args(["--device", "cpu", "--dataset",
                                    "synthetic"])
    assert cfg.model.fused_inference is False
    cfg, _, _ = trainer.parse_args(["--device", "cpu", "--dataset",
                                    "synthetic", "--fused-inference"])
    assert cfg.model.fused_inference is True


@pytest.mark.parametrize("what", ["n_devices", "wandb"])
def test_still_refused(what):
    """wandb is not ported. Data parallel training is (`--n-devices 2`
    parses), and refuses, as `main.py`, a batch that does not divide
    over its ranks."""
    argv = ["--device", "cpu", "--dataset", "synthetic"]
    if what == "n_devices":
        cfg, _, _ = trainer.parse_args(argv + ["--n-devices", "2"])
        assert cfg.train.n_devices == 2
        with pytest.raises(ValueError, match="must be a multiple of the "
                           "3-device mesh"):
            trainer.parse_args(argv + ["--n-devices", "3"])
        return
    with pytest.raises(pc.NotPortedError, match="not ported yet"):
        trainer.parse_args(argv + ["--wandb-mode", "online"])


FLAG_SETS = [
    [],
    ["--input-modalities", "rgbd", "--rgbd-encoder-backbone", "resnet50",
     "--rgbd-encoder-backbone-resnet-block", "basicblock", "--activation",
     "swish", "--encoder-normalization", "layernorm",
     "--decoder-normalization", "groupnorm", "--he-init", "encoder-fusion",
     "decoder", "--no-zero-init-decoder-residuals", "--context-module",
     "appm-1-2-4-8", "--upsampling-context-module", "nearest",
     "--upsampling-prediction", "learned-3x3",
     "--encoder-decoder-skip-downsamplings", "4", "8", "--dropout-p",
     "0.3", "--compute-dtype", "bfloat16"],
    ["--tasks", "semantic", "instance", "normal", "--semantic-decoder",
     "segformermlp", "--instance-decoder-block", "bottleneck",
     "--normal-decoder-n-blocks", "2", "--normal-decoder-n-channels",
     "256", "128", "--normal-decoder-downsamplings", "8", "4",
     "--normal-decoder-upsampling", "bilinear",
     "--normal-encoder-decoder-fusion", "add-depth",
     "--normal-no-multiscale-supervision", "--semantic-decoder-dropout-p",
     "0.3", "--normal-decoder-block-dropout-p", "0.1",
     "--instance-decoder-dropout-p", "0.2", "--normal-decoder-dropout-p",
     "0.4", "--normal-decoder", "emsanet", "--normal-loss", "l1"],
    ["--encoder-decoder-fusion", "add-rgbd", "--upsampling-decoder",
     "nearest", "--normalization", "groupnorm",
     "--rgb-encoder-backbone-block", "basicblock",
     "--depth-encoder-backbone-resnet-block", "bottleneck",
     "--rgbd-encoder-backbone-block", "basicblock",
     "--semantic-decoder-upsampling", "bilinear"],
    ["--tasks", "semantic", "instance", "--enable-panoptic",
     "--instance-center-heatmap-threshold", "0.2",
     "--instance-center-heatmap-nms-kernel-size", "9",
     "--instance-center-heatmap-apply-foreground-mask",
     "--instance-center-heatmap-top-k", "32",
     "--instance-center-encoding", "none", "--instance-offset-encoding",
     "deeplab", "--instance-offset-distance-threshold", "40",
     "--instance-center-sigma", "6", "--semantic-decoder-n-blocks", "1",
     "--instance-decoder-n-channels", "256", "128", "64",
     "--instance-decoder-downsamplings", "16", "8", "4",
     "--instance-decoder-upsampling", "nearest"],
    ["--input-modalities", "depth", "--rgb-encoder-backbone", "resnet18se",
     "--depth-encoder-backbone", "resnet34-d16", "--fused-inference",
     "--fused-training", "--head-decode-fusion", "auto", "--batch-size",
     "4", "--encoder-fusion", "add-uni-depth",
     "--encoder-backbone-pretrained-weights-filepath", "/nonexistent.pth",
     "--input-height", "96", "--input-width", "128"],
]


@pytest.mark.parametrize("argv", FLAG_SETS, ids=[
    "defaults", "encoder", "decoders", "aliases", "instance", "single"])
def test_model_flags_parse_as_jax(argv):
    want = jax_cli.args_to_config(jax_cli.build_parser().parse_args(argv))
    got, _, _ = trainer.parse_args(["--device", "cpu"] + argv)
    common = ({f.name for f in dataclasses.fields(pc.ModelConfig)}
              & {f.name for f in dataclasses.fields(JaxModelConfig)})
    assert len(common) > 70
    for name in sorted(common):
        assert getattr(got.model, name) == getattr(want.model, name), name
    assert got.train.normal_loss == want.train.normal_loss


def _normals(rng, shape):
    n = rng.randn(*shape, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[rng.rand(*shape) < 0.2] = 0.0  # invalid pixels: the zero vector
    return n


def test_l1_normal_matches_jax():
    rng = np.random.RandomState(1)
    pred, target = _normals(rng, (2, 9, 11)), _normals(rng, (2, 9, 11))
    mask = np.linalg.norm(target, axis=-1) > 0.5
    for m in (None, mask):
        want = float(jax_losses.l1_normal(pred, target, m))
        got = float(losses.l1_normal(
            torch.from_numpy(pred), torch.from_numpy(target),
            None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_normal_mask_generator_matches_jax():
    rng = np.random.RandomState(2)
    sample = {"normal": _normals(rng, (12, 16)),
              "_down_8": {"normal": _normals(rng, (2, 2))},
              "_down_4": {"normal": _normals(rng, (3, 4))}}
    want = jax_transforms.NormalMaskGenerator()(
        {k: (dict(v) if isinstance(v, dict) else v.copy())
         for k, v in sample.items()})
    got = transforms.NormalMaskGenerator()(sample)
    np.testing.assert_array_equal(got["normal_mask"], want["normal_mask"])
    for s in ("_down_8", "_down_4"):
        np.testing.assert_array_equal(got[s]["normal_mask"],
                                      want[s]["normal_mask"])


def test_normal_task_helper_matches_jax():
    rng = np.random.RandomState(3)
    port, ref = th.NormalTaskHelper(), jax_th.NormalTaskHelper()
    port.initialize()
    ref.initialize()
    for i in range(3):
        target = _normals(rng, (3, 10, 12))
        pred = target + 0.3 * rng.randn(*target.shape).astype(np.float32)
        pred /= np.linalg.norm(pred, axis=-1, keepdims=True) + 1e-9
        batch = {"normal": target,
                 "_valid_mask": np.array([True, True, i != 2])}
        port.validation_step(batch, {"normal": pred})
        ref.validation_step(batch, {"normal": pred})
    got, want = port.validation_epoch_end(), ref.validation_epoch_end()
    assert got == want
    assert 5.0 < got[1]["normal_mae_deg"] < 60.0
    cfg = pc.EMSANetConfig(model=pc.ModelConfig(tasks=("normal",)))
    helpers = th.get_task_helpers(cfg, get_dataset_config("synthetic"))
    assert [type(h) for h in helpers] == [th.NormalTaskHelper]
    assert "normal" in th.PREDICTION_KEYS
