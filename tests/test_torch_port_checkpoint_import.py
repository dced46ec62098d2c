"""Checkpoint import into the port, on the CPU: upstream PyTorch
checkpoints (`import_torch_checkpoint.py`, `torch_compat/name_map.py`)
and the JAX package's checkpoints (`training/jax_checkpoint.py`,
through `weights.load_weights_file`, which `--weights-filepath` calls).

Upstream: a random `emsanet_tpu/torch_compat/mirror.py::TorchEMSANet`
(R18 stages (2, 2, 2, 2); `randomize_batchnorm_stats`) saved as a
`{'state_dict': ...}` file with the 'model.' prefix and the
'fused_encoders.' alias, imported by the port's tool. The port's eval
forward is held to the mirror's forward and to the JAX model's after the
JAX package's tool (`tools/import_torch_checkpoint.py`) converts the
same file, at f32, atol 1e-4 + rtol 1e-3 (conv accumulation order), on
96x128 inputs drawn from a numpy seed. The imported tensors equal the
mirror's bit for bit. The name map covers the port's whole training
`state_dict` and the mirror's whole `state_dict`, one to one, for R34
and R18 stages, with and without orientation.

JAX: a checkpoint written by `emsanet_tpu.training.checkpoint.
save_checkpoint` (numpy-seeded variables, SGD state) loads into the
port, whose forward equals the JAX model's at the same tolerance; the
port's msgpack decoder gives what `flax.serialization.msgpack_restore`
gives on that file, leaf for leaf and bit for bit.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_tmp_files import remove_large_files
from flax import serialization
from test_torch_port_model import _random_variables

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu.torch_compat.mirror import (
    TorchEMSANet,
    randomize_batchnorm_stats,
)
from emsanet_tpu.torch_compat.name_map import (
    emsanet_torch_name_map as jax_name_map,
)
from emsanet_tpu.training import create_train_state, get_optimizer
from emsanet_tpu.training.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from emsanet_tpu.training.checkpoint import save_checkpoint as jax_save
from emsanet_tpu.weights import _unflatten
from emsanet_tpu_torch import import_torch_checkpoint as tool
from emsanet_tpu_torch.config import flagship_config
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.emsanet import EMSANet, build_model
from emsanet_tpu_torch.torch_compat.name_map import emsanet_torch_name_map
from emsanet_tpu_torch.training import jax_checkpoint
from emsanet_tpu_torch.training.checkpoint import load_checkpoint
from emsanet_tpu_torch.weights import load_weights_file

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import import_torch_checkpoint as jax_tool  # noqa: E402

ATOL, RTOL = 1e-4, 1e-3
H, W = 96, 128
TASKS = ("semantic", "instance", "orientation", "scene")
STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """The checkpoints a test writes go once it is done."""
    yield
    remove_large_files(tmp_path)



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("backbone", sorted(STAGES))
@pytest.mark.parametrize("orientation", [True, False])
def test_name_map_covers_the_port_state_dict(backbone, orientation):
    tasks = TASKS if orientation else ("semantic", "instance", "scene")
    name_map = emsanet_torch_name_map(STAGES[backbone], tasks)
    model = EMSANet(flagship_config(
        tasks=tasks, rgb_encoder_backbone=backbone,
        depth_encoder_backbone=backbone), get_dataset_config("synthetic"),
        train=True)
    own = set(model.state_dict())
    assert len(set(name_map.values())) == len(name_map)  # one to one
    assert set(name_map.values()) == own, (
        sorted(own - set(name_map.values()))[:5],
        sorted(set(name_map.values()) - own)[:5])
    assert set(name_map) == set(jax_name_map(STAGES[backbone], tasks))
    mirror = TorchEMSANet(STAGES[backbone], with_orientation=orientation)
    assert set(name_map) == {k for k in mirror.state_dict()
                             if not k.endswith("num_batches_tracked")}


def _upstream_file(path, mirror):
    """The mirror's state dict as an upstream checkpoint: wrapped, with
    the 'model.' prefix and the 'fused_encoders.' alias."""
    sd = {}
    for key, value in mirror.state_dict().items():
        if key.startswith("encoder."):
            key = "fused_encoders." + key[len("encoder."):]
        sd["model." + key] = value
    torch.save({"state_dict": sd, "epoch": 7}, path)


@pytest.fixture(scope="module")
def mirror():
    torch.manual_seed(0)
    model = TorchEMSANet(STAGES["resnet18"]).eval()
    randomize_batchnorm_stats(model)
    return model


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(2, H, W, 3).astype(np.float32),
            rng.randn(2, H, W, 1).astype(np.float32))


def _port_model(dataset="synthetic"):
    cfg = flagship_config(input_height=H, input_width=W,
                          rgb_encoder_backbone="resnet18",
                          depth_encoder_backbone="resnet18")
    return build_model(cfg, get_dataset_config(dataset), device="cpu",
                       seed=None)


def _port_outputs(model, rgb, depth):
    out = model({"rgb": torch.from_numpy(rgb),
                 "depth": torch.from_numpy(depth)})
    return {"semantic": out["semantic"]["logits"].numpy(),
            "center": out["instance"]["center"].numpy(),
            "offset": out["instance"]["offset"].numpy(),
            "orientation": out["instance"]["orientation"].numpy(),
            "scene": out["scene"]["logits"].numpy()}


def _jax_model():
    cfg = JaxEMSANetConfig(
        model=JaxModelConfig(tasks=TASKS, enable_panoptic=True,
                             input_height=H, input_width=W,
                             rgb_encoder_backbone="resnet18",
                             depth_encoder_backbone="resnet18"),
        data=JaxDataConfig(dataset="synthetic"),
        train=JaxTrainConfig()).validate()
    return JaxEMSANet(cfg=cfg.model,
                      dataset_config=jax_ds_config(cfg.data)), cfg


def _jax_outputs(model, variables, rgb, depth):
    out = model.apply(variables, {"rgb": jnp.asarray(rgb),
                                  "depth": jnp.asarray(depth)}, train=False)
    return {"semantic": out["semantic"]["logits"],
            "center": out["instance"]["center"],
            "offset": out["instance"]["offset"],
            "orientation": out["instance"]["orientation"],
            "scene": out["scene"]["logits"]}


def _close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_upstream_import_matches_mirror_and_jax(mirror, inputs, tmp_path,
                                                capsys):
    src = str(tmp_path / "emsanet.pth")
    _upstream_file(src, mirror)
    assert tool.main([src, str(tmp_path), "--backbone", "resnet18",
                      "--device", "cpu"]) == 0
    out = tmp_path / tool.OUT_NAME
    assert "0 unmatched keys" in capsys.readouterr().out
    # the imported tensors are the mirror's, bit for bit
    saved = torch.load(out, weights_only=True)["model"]
    for t_key, p_key in emsanet_torch_name_map(STAGES["resnet18"]).items():
        assert torch.equal(saved[p_key], mirror.state_dict()[t_key]), t_key

    model = _port_model()
    load_weights_file(str(out), model, verbose=False)
    rgb, depth = inputs
    got = _port_outputs(model, rgb, depth)
    with torch.no_grad():
        m = mirror(torch.from_numpy(rgb).permute(0, 3, 1, 2),
                   torch.from_numpy(depth).permute(0, 3, 1, 2))
    _close(got, {
        "semantic": m["semantic_logits"].permute(0, 2, 3, 1).numpy(),
        "center": m["instance_center"].permute(0, 2, 3, 1).numpy(),
        "offset": m["instance_offset"].permute(0, 2, 3, 1).numpy(),
        "orientation": m["instance_orientation"].permute(0, 2, 3, 1).numpy(),
        "scene": m["scene_logits"].numpy()})

    raw = torch.load(src, weights_only=True)["state_dict"]
    params, stats, unmatched = jax_tool.convert_state_dict(
        raw, stage_blocks=STAGES["resnet18"], verbose=False)
    assert not unmatched
    jmodel, _ = _jax_model()
    variables = {"params": _unflatten(params),
                 "batch_stats": _unflatten(stats)}
    _close(got, _jax_outputs(jmodel, variables, rgb, depth))


def test_import_renames_skips_and_reports(mirror, tmp_path, capsys):
    """--rename-json re-keys a prefix; num_batches_tracked is skipped;
    an unknown key is reported; --n-semantic-classes 37 keeps the first
    37 classes of the 40-class head (the transfer rules)."""
    src = str(tmp_path / "renamed.pth")
    sd = {k.replace("context_module.", "ctx."): v
          for k, v in mirror.state_dict().items()}
    sd["decoders.extra_head.weight"] = torch.zeros(3)
    torch.save(sd, src)
    renames = tmp_path / "renames.json"
    renames.write_text(json.dumps({"ctx.": "context_module."}))
    assert tool.main([src, str(tmp_path), "--backbone", "resnet18",
                      "--n-semantic-classes", "37", "--rename-json",
                      str(renames), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "1 unmatched keys" in text
    assert "unmatched: decoders.extra_head.weight" in text
    assert "num_batches_tracked" not in text
    saved = torch.load(tmp_path / tool.OUT_NAME, weights_only=True)["model"]
    head = mirror.state_dict()["decoders.semantic_decoder.head.conv.weight"]
    assert torch.equal(saved["semantic_decoder.head_conv.weight"], head[:37])
    assert torch.equal(saved["context_module.fuse.Conv_0.weight"],
                       mirror.state_dict()["context_module.fuse.conv.weight"])


# ---------------------------------------------------------------------------
# the JAX package's checkpoints


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """(path, JAX model, variables): a checkpoint of numpy-seeded
    variables and their SGD state, written by the JAX package."""
    jmodel, cfg = _jax_model()
    shapes = jax.eval_shape(
        lambda k: init_model(jmodel, k, batch_size=1, train=True),
        jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), 21)
    state = create_train_state(jmodel, variables, get_optimizer(cfg.train))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt.msgpack")
    jax_save(path, state, 3, logs={"valid_miou": 0.5}, extra={"a": [1, 2]})
    yield path, jmodel, variables
    remove_large_files(os.path.dirname(path))


def test_jax_checkpoint_forward_matches_jax(jax_ckpt, inputs):
    path, jmodel, variables = jax_ckpt
    assert jax_checkpoint.is_jax_checkpoint(path)
    model = _port_model()
    load_weights_file(path, model, verbose=False)
    rgb, depth = inputs
    _close(_port_outputs(model, rgb, depth),
           _jax_outputs(jmodel, variables, rgb, depth))


def _same_tree(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{where}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        assert g.tobytes() == w.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


def test_msgpack_decoder_matches_flax_on_a_checkpoint(jax_ckpt):
    path, _, _ = jax_ckpt
    payload, meta = jax_checkpoint.read_checkpoint(path)
    with open(path, "rb") as fh:
        blob = fh.read()
    n = int.from_bytes(blob[8:16], "little")
    _same_tree(payload, serialization.msgpack_restore(blob[16 + n:]))
    want = jax_load_checkpoint(path)
    assert meta == {k: want[k] for k in ("epoch", "logs", "extra")}
    assert sorted(jax_checkpoint.read_variables(path)) == ["batch_stats",
                                                           "params"]


def test_msgpack_decoder_matches_flax_on_every_type(monkeypatch):
    """Integers and strings of every width, floats, None, bools, bytes,
    lists, numpy scalars and arrays of several dtypes; a complex and an
    array split into chunks (flax's chunk size lowered to 64 bytes),
    which no EMSANet checkpoint holds, raise."""
    rng = np.random.RandomState(2)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40,
                 -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**40],
        "floats": [0.5, -1e300, 3.25e-7],
        "misc": [None, True, False, "", "é" * 20, "x" * 300, "y" * 70000,
                 b"", b"\x00" * 300, b"\x01" * 70000],
        "scalars": {"i": np.int32(-5), "f": np.float32(0.25),
                    "u": np.uint8(200)},
        "arrays": {str(i): a for i, a in enumerate([
            rng.randn(3, 4).astype(np.float32), np.arange(7, dtype=np.int64),
            rng.rand(5) < 0.5, np.zeros((0, 2), np.float64),
            rng.randint(0, 255, (2, 3, 4)).astype(np.uint8),
            rng.randn(40).astype(np.float32)])},
        "wide": {str(i): {"k": i} for i in range(20)},
    }
    blob = serialization.msgpack_serialize(tree)
    _same_tree(jax_checkpoint.msgpack_restore(blob),
               serialization.msgpack_restore(blob))
    bf16 = serialization.msgpack_serialize(
        {"w": jnp.asarray([1.5, -2.25, 3e38], jnp.bfloat16)})
    np.testing.assert_array_equal(
        jax_checkpoint.msgpack_restore(bf16)["w"],
        np.asarray([1.5, -2.25, 3e38], jnp.bfloat16).astype(np.float32))
    with pytest.raises(ValueError):
        jax_checkpoint.msgpack_restore(blob[:-1])
    with pytest.raises(ValueError, match="unknown ext type 2"):
        jax_checkpoint.msgpack_restore(
            serialization.msgpack_serialize({"c": 1 + 2j}))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    chunked = serialization.msgpack_serialize(
        {"w": rng.randn(40).astype(np.float32)})  # 160 bytes: 3 chunks
    assert b"__msgpack_chunked_array__" in chunked
    with pytest.raises(ValueError, match="chunked array"):
        jax_checkpoint.msgpack_restore(chunked)


def test_resume_refuses_a_jax_checkpoint(jax_ckpt):
    path = jax_ckpt[0]
    with pytest.raises(ValueError, match="JAX package checkpoint"):
        load_checkpoint(path, _port_model())


def test_jax_checkpoint_in_the_trainer(jax_ckpt, tmp_path, capsys):
    """`--weights-filepath` of a JAX file validates from its weights."""
    from emsanet_tpu_torch import train as trainer

    argv = ["--device", "cpu", "--dataset", "synthetic", "--tasks", *TASKS,
            "--enable-panoptic", "--rgb-encoder-backbone", "resnet18",
            "--depth-encoder-backbone", "resnet18", "--input-height",
            str(H), "--input-width", str(W), "--batch-size", "2",
            "--validation-batch-size", "2", "--synthetic-n-samples", "2",
            "--class-weighting", "none", "--n-workers", "1",
            "--fused-inference", "--validation-only", "--skip-sanity-check",
            "--weights-filepath", jax_ckpt[0], "--results-basepath",
            str(tmp_path)]
    assert trainer.main(argv) == 0
    logs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(logs["valid_semantic_miou"])
    assert not os.path.exists(os.path.join(tmp_path, "finished"))
