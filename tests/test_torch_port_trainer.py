"""The port's trainer (`emsanet_tpu_torch/train.py`): validation on
stepped weights, checkpoints, resume, the sanity check, the run
directory and its `metrics.csv`, on the CPU.

Small configurations: R18 flagship (semantic, instance, orientation,
scene, panoptic), f32, synthetic data with run 4's flags
(`results_samples/train_run_r5/run4_bce/argsv.txt`) where a test says
so. Everything that must be unchanged is compared bit for bit.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from torch_tmp_files import remove_large_files

from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.config import NotPortedError
from emsanet_tpu_torch.training.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from emsanet_tpu_torch.training.step import extract_device_batch

HERE = os.path.dirname(os.path.abspath(__file__))
RUN4 = os.path.join(HERE, "..", "results_samples", "train_run_r5",
                    "run4_bce")
TASKS = ("semantic", "instance", "orientation", "scene")


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """The checkpoints a test writes go once it is done."""
    yield
    remove_large_files(tmp_path)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: an idle pool's threads would spin
    beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(h=64, w=96, n=4, batch_size=2, head="decode", megakernel="auto",
         **train):
    return pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(tasks=TASKS, enable_panoptic=True,
                             input_height=h, input_width=w,
                             rgb_encoder_backbone="resnet18",
                             depth_encoder_backbone="resnet18",
                             fused_training=True, fused_inference=True,
                             head_decode_fusion=head,
                             decoder_megakernel=megakernel),
        data=pc.DataConfig(dataset="synthetic", batch_size=batch_size,
                           validation_batch_size=batch_size,
                           synthetic_n_samples=n, n_workers=2,
                           class_weighting="none"),
        train=pc.TrainConfig(**train)))


def _states(run):
    """The model's and the optimizer's state as numpy arrays."""
    out = {f"model/{k}": v.detach().numpy().copy()
           for k, v in run.model.state_dict().items()}
    for i, st in run.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"opt/{i}/{k}"] = v.numpy().copy()
    return out


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k].view(np.uint8),
                              want[k].view(np.uint8)), k


def _one_step(run, epoch=0):
    batch = next(iter(run.data.train_loader.batches(epoch)))
    return run.train_step(extract_device_batch(batch, run.device),
                          trainer.dropout_generator_for(0, epoch, 0, "cpu"))


def _validate(run):
    """(logs, every eval output of every batch) of a validation."""
    outputs = []
    step = run.eval_step

    def spy(batch):
        out = step(batch)
        outputs.append({k: v.clone() for k, v in out.items()})
        return out

    run.eval_step = spy
    try:
        logs = trainer.run_validation(run, 0)
    finally:
        run.eval_step = step
    return logs, outputs


def _same_outputs(a, b):
    return len(a) == len(b) and all(
        sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


@pytest.mark.parametrize("megakernel", ["off", "on"])
def test_validation_sees_stepped_weights(megakernel):
    """Validate, step, validate: the second validation equals a fresh
    model given the stepped weights, and the model whose derived weights
    (stem, chains, trunk, parity taps) were cached under the old ones
    and then loaded with them. 128x160, so both heads defer
    (decode-planes)."""
    cfg = _cfg(128, 160, head="decode-planes", megakernel=megakernel)
    run = trainer.setup(cfg, "cpu")
    _, before = _validate(run)
    _one_step(run)
    logs1, after = _validate(run)
    assert not _same_outputs(before, after)
    fresh = trainer.setup(cfg, "cpu")
    fresh.model.load_state_dict(run.model.state_dict())
    assert logs1 == _validate(fresh)[0]
    assert _same_outputs(after, _validate(fresh)[1])
    cached = trainer.setup(cfg, "cpu")
    _validate(cached)  # derived weights cached for the initial ones
    cached.model.load_state_dict(run.model.state_dict())
    logs2, again = _validate(cached)
    assert logs2 == logs1 and _same_outputs(again, after)
    assert "instance_orientation_planes" in after[0]


def test_mixed_precision_eval_equals_bf16_weights():
    """The bf16 eval of a --mixed-precision model's f32 parameters (the
    upsamplings below the polyphase gate cast their weight at use) gives
    the outputs of the same weights cast to bf16 beforehand, bit for bit.
    128x160, so both heads defer (decode-planes) and the small maps stay
    below the gate. The initial weights: their BatchNorm statistics (0
    and 1) are exact in bf16, and an eval BatchNorm of f32 statistics
    computes in f32 where one of bf16 statistics would not."""
    from emsanet_tpu_torch.datasets.metadata import get_dataset_config
    from emsanet_tpu_torch.training.step import make_eval_step

    cfg = _cfg(128, 160, head="decode-planes", mixed_precision=True)
    assert cfg.model.compute_dtype == "bfloat16"
    run = trainer.setup(cfg, "cpu")
    assert all(p.dtype == torch.float32 for p in run.model.parameters())
    (loader,) = run.data.valid_loaders.values()
    batch = next(iter(loader.batches(0)))
    inputs = {k: torch.from_numpy(batch[k]) for k in trainer.EVAL_KEYS
              if k in batch}
    got = run.eval_step(inputs)
    ds = get_dataset_config("synthetic")
    want = make_eval_step(
        copy.deepcopy(run.model).to(torch.bfloat16), cfg,
        torch.tensor(ds.classes_is_thing),
        use_orientations=torch.tensor(ds.classes_use_orientations))(inputs)
    assert "instance_orientation_planes" in got
    assert got["semantic_segmentation_idx"].shape == (2, 128, 160)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if v.is_floating_point():
            assert torch.isfinite(v).all(), k
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cfg = _cfg()
    run = trainer.setup(cfg, "cpu")
    _one_step(run)  # momentum buffers exist
    path = str(tmp_path / "ckpt_resume.pt")
    logs = {"epoch": 4, "valid_semantic_miou": 0.25, "note": "x"}
    save_checkpoint(path, run.model, run.optimizer, 4, logs)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_resume.pt"]
    other = trainer.setup(_cfg(), "cpu")
    epoch, got_logs = load_checkpoint(path, other.model, other.optimizer)
    assert epoch == 4 and got_logs == logs
    _assert_states_equal(_states(other), _states(run))
    assert other.optimizer.state_dict()["param_groups"] == \
        run.optimizer.state_dict()["param_groups"]


def test_checkpoint_file_holds_only_its_tensors(tmp_path):
    """The file's bytes are its tensors' bytes plus a small overhead: no
    tensor drags a larger storage (a view of a stacked copy or of a
    shared buffer) into the file."""
    run = trainer.setup(_cfg(), "cpu")
    _one_step(run)
    path = tmp_path / "ckpt_resume.pt"
    save_checkpoint(str(path), run.model, run.optimizer, 0)
    tensors = list(run.model.state_dict().values()) + [
        v for st in run.optimizer.state_dict()["state"].values()
        for v in st.values() if torch.is_tensor(v)]
    nbytes = sum(t.nelement() * t.element_size() for t in tensors)
    overhead = os.path.getsize(path) - nbytes
    assert 0 <= overhead < 1024 * len(tensors), (overhead, nbytes)


def test_sanity_check_leaves_model_and_optimizer_unchanged():
    run = trainer.setup(_cfg(), "cpu")
    _one_step(run)
    before = _states(run)
    versions = [p._version for p in run.model.parameters()]
    loss = trainer.sanity_check(run)
    assert np.isfinite(loss)
    _assert_states_equal(_states(run), before)
    assert versions == [p._version for p in run.model.parameters()]
    assert run.model.training


def _train(cfg, tmp_path, name):
    run = trainer.setup(cfg, "cpu")
    run_dir = str(tmp_path / name)
    for sub in ("checkpoints", "artifacts"):
        os.makedirs(os.path.join(run_dir, sub))
    return run, run_dir


def test_resume_equals_a_straight_run(tmp_path):
    """3 straight epochs against 2 epochs, a failure in the third (error
    checkpoint and error.log) and a resume from the resume checkpoint of
    epoch 1: the same weights, optimizer state and last logs, bit for
    bit (f32)."""
    kw = dict(n_epochs=3, resume_ckpt_interval=2, validation_skip=1.0,
              validation_force_interval=100, overfit_n_batches=1,
              skip_sanity_check=True)
    straight, run_dir = _train(_cfg(**kw), tmp_path, "straight")
    want_logs = trainer.train(straight, run_dir)
    assert os.path.exists(os.path.join(run_dir, "finished"))
    remove_large_files(run_dir)  # only the broken run's are read

    broken, run_dir = _train(_cfg(**kw), tmp_path, "broken")
    step = broken.train_step
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("interrupted")
        return step(*a)

    broken.train_step = failing
    with pytest.raises(RuntimeError, match="interrupted"):
        trainer.train(broken, run_dir)
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert ckpts == ["ckpt_error__epoch_0002.pt", "ckpt_resume.pt"]
    with open(os.path.join(run_dir, "error.log")) as fh:
        assert "interrupted" in fh.read()
    assert not os.path.exists(os.path.join(run_dir, "finished"))

    resume = os.path.join(run_dir, "checkpoints", "ckpt_resume.pt")
    resumed, run_dir = _train(
        _cfg(**{**kw, "skip_sanity_check": False},
             resume_ckpt_filepath=resume), tmp_path, "resumed")
    got_logs = trainer.train(resumed, run_dir)
    _assert_states_equal(_states(resumed), _states(straight))
    strip = ("time_train_s", "time_valid_s")
    assert {k: v for k, v in got_logs.items() if k not in strip} == {
        k: v for k, v in want_logs.items() if k not in strip}


def _run4_argv(tmp_path, n_epochs=2):
    """Run 4's flags at 64x96 with R18 encoders (results under tmp)."""
    with open(os.path.join(RUN4, "argsv.txt")) as fh:
        argv = fh.read().split()
    return ["--device", "cpu", *argv, "--rgb-encoder-backbone", "resnet18",
            "--depth-encoder-backbone", "resnet18", "--input-height", "64",
            "--input-width", "96", "--n-epochs", str(n_epochs),
            "--n-workers", "2", "--results-basepath", str(tmp_path)]


def test_run4_flags_write_run4_csv_columns(tmp_path, capsys):
    """A 2-epoch run with run 4's flags: the run directory, and a
    metrics.csv whose header is run 4's, name for name and in order."""
    assert trainer.main(_run4_argv(tmp_path)) == 0
    (run_dir,) = [os.path.join(tmp_path, "synthetic", d)
                  for d in os.listdir(os.path.join(tmp_path, "synthetic"))]
    with open(os.path.join(RUN4, "metrics.csv")) as fh:
        want = fh.readline().strip().split(",")
    with open(os.path.join(run_dir, "metrics.csv")) as fh:
        rows = fh.read().strip().splitlines()
    assert rows[0].split(",") == want and len(rows) == 3
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "ckpt_resume.pt", "ckpt_semantic_miou_epoch_0001.pt"]
    assert os.listdir(os.path.join(run_dir, "artifacts")) == [
        "semantic_confusion_epoch_1.npy"]
    for name in ("args.json", "argsv.txt", "finished"):
        assert os.path.exists(os.path.join(run_dir, name))
    with open(os.path.join(run_dir, "args.json")) as fh:
        args = json.load(fh)
    assert args["model"]["head_decode_fusion"] == "decode-planes"  # auto, b8
    assert args["train"]["overfit_n_batches"] == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["epoch"] == 1 and np.isfinite(last["valid_semantic_miou"])


def test_validation_only_from_a_checkpoint(tmp_path, capsys):
    run = trainer.setup(_cfg(), "cpu")
    _one_step(run)
    path = str(tmp_path / "w.pt")
    save_checkpoint(path, run.model, run.optimizer, 0)
    want = trainer.run_validation(run, 0)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--tasks", *TASKS,
            "--enable-panoptic", "--rgb-encoder-backbone", "resnet18",
            "--depth-encoder-backbone", "resnet18", "--input-height", "64",
            "--input-width", "96", "--batch-size", "2",
            "--validation-batch-size", "2", "--synthetic-n-samples", "4",
            "--fused-training", "--fused-inference", "--class-weighting",
            "none", "--n-workers", "2", "--validation-only",
            "--skip-sanity-check",
            "--weights-filepath", path, "--results-basepath",
            str(tmp_path / "runs")]
    assert trainer.main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        want
    (run_dir,) = (tmp_path / "runs" / "synthetic").iterdir()
    assert not (run_dir / "finished").exists()
    assert (run_dir / "metrics.csv").read_text().count("\n") == 2


@pytest.mark.parametrize("flags,error", [
    (["--n-devices", "3"], ValueError),
    (["--wandb-mode", "online"], NotPortedError),
    (["--wandb-mode", "offline"], NotPortedError),
], ids=["flags0", "flags1", "flags2"])
def test_unported_flags_are_refused(flags, error):
    """wandb is not ported; `--n-devices` is (data parallel), and refuses
    a batch size (8) that does not divide over its ranks."""
    with pytest.raises(error):
        trainer.parse_args(["--device", "cpu", "--dataset", "synthetic",
                            *flags])
