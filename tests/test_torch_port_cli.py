"""The trainer's command line (`emsanet_tpu_torch/train.py`) against the
JAX package's (`emsanet_tpu/utils/cli.py`), on the CPU.

Every option of the JAX parser is accepted, and the same argv gives
equal configuration values in every field that both configurations
have: each `configs/*.json` through `--config` (alone and under explicit
flags), each deprecated alias, the run's bookkeeping and dataset flags,
`--remat`, and `resume <run_dir>` (the run's recorded argv, its resume
checkpoint and later flags). `resume` also continues a real run through
`train.main`.
"""

import dataclasses
import glob
import json
import os

import pytest
import torch
from torch_tmp_files import remove_large_files

from emsanet_tpu.config import DataConfig as JaxDataConfig
from emsanet_tpu.config import ModelConfig as JaxModelConfig
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.utils import cli as jax_cli
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import train as trainer

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = sorted(glob.glob(os.path.join(HERE, "..", "configs", "*.json")))
SECTIONS = (("model", pc.ModelConfig, JaxModelConfig),
            ("data", pc.DataConfig, JaxDataConfig),
            ("train", pc.TrainConfig, JaxTrainConfig))


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    yield
    remove_large_files(tmp_path)


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_every_jax_option_is_accepted():
    missing = _options(jax_cli.build_parser()) - _options(
        trainer.build_parser())
    assert not missing


def _assert_parse_as_jax(argv):
    """Both parsers on `argv` (`--device cpu` first): every field that
    both configurations have is equal; returns the port's config."""
    _, ns, _ = jax_cli.parse_args(["--device", "cpu", *argv])
    want = jax_cli.args_to_config(ns)
    got, device, _ = trainer.parse_args(["--device", "cpu", *argv])
    assert device == "cpu"
    n = 0
    for section, port_cls, jax_cls in SECTIONS:
        common = ({f.name for f in dataclasses.fields(port_cls)}
                  & {f.name for f in dataclasses.fields(jax_cls)})
        for name in sorted(common - {"resume_ckpt_filepath"}):
            assert (getattr(getattr(got, section), name)
                    == getattr(getattr(want, section), name)), (section,
                                                                 name)
            n += 1
    assert n > 120
    return got, want


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
@pytest.mark.parametrize("extra", [
    [], ["--batch-size", "4", "--n-epochs", "3", "--input-height", "240",
         "--learning-rate", "0.5", "--class-weighting", "linear"]],
    ids=["file", "overridden"])
def test_config_file_parses_as_jax(path, extra):
    got, _ = _assert_parse_as_jax(["--config", path, *extra])
    with open(path) as fh:
        file_cfg = json.load(fh)
    if extra:
        assert got.data.batch_size == 4 and got.train.n_epochs == 3
        assert got.model.input_height == 240
        assert got.data.class_weighting == "linear"
    else:
        assert got.data.batch_size == file_cfg["data"].get("batch_size", 8)
        assert list(got.model.tasks) == file_cfg["model"]["tasks"]


ALIASES = [
    ["--label-smoothing", "0.1"],
    ["--label-smoothing", "0.1", "--semantic-loss-label-smoothing", "0.3"],
    ["--class-weighting", "logarithmic", "--class-weighting-c", "1.1"],
    ["--semantic-class-weighting", "linear",
     "--semantic-class-weighting-logarithmic-c", "1.5"],
    ["--encoder-decoder-fusion", "add-depth", "--upsampling-decoder",
     "bilinear", "--normalization", "layernorm"],
    ["--rgb-encoder-backbone-block", "basicblock",
     "--depth-encoder-backbone-block", "bottleneck"],
    ["--wandb-name", "old-name", "--wandb-project", "new"],
]


@pytest.mark.parametrize("argv", ALIASES, ids=[
    "label_smoothing", "label_smoothing_wins", "class_weighting",
    "logarithmic_c", "decoder_aliases", "backbone_blocks", "wandb_name"])
def test_deprecated_alias_parses_as_jax(argv):
    _assert_parse_as_jax(argv)


def test_bookkeeping_dataset_and_remat_flags_parse_as_jax():
    got, _ = _assert_parse_as_jax([
        "--debug", "--hostname", "node-7", "--notes", "a note",
        "--disable-progress-bars", "--remat", "--learning-rate-scheduler",
        "onecycle", "--sunrgbd-depth-do-not-force-mm",
        "--sunrgbd-instances-version", "emsanet", "--dataset", "sunrgbd"])
    assert got.model.remat and got.train.debug
    assert (got.train.hostname, got.train.notes) == ("node-7", "a note")
    with pytest.warns(UserWarning, match="hypersim_use_old_depth_stats"):
        got, _ = _assert_parse_as_jax(["--dataset", "hypersim",
                                       "--hypersim-use-old-depth-stats"])
    assert got.data.hypersim_use_old_depth_stats


def _write_run_dir(tmp_path, argv):
    cfg, _, argv = trainer.parse_args(argv)
    cfg.train.results_basepath = str(tmp_path)
    return trainer.make_run_dir(cfg, argv)


def test_resume_parses_as_jax(tmp_path):
    run_dir = _write_run_dir(tmp_path, [
        "--device", "cpu", "--config", CONFIGS[0], "--batch-size", "2",
        "--notes", "first"])
    with open(os.path.join(run_dir, "args.json")) as fh:
        recorded = json.load(fh)
    assert recorded["train"]["notes"] == "first"
    assert recorded["train"]["hostname"]
    argv = ["resume", run_dir, "--n-epochs", "9"]
    _, ns, _ = jax_cli.parse_args(argv)
    want = jax_cli.args_to_config(ns)
    got, device, used = trainer.parse_args(argv)
    assert device == "cpu" and used[-2:] == ["--n-epochs", "9"]
    assert got.train.n_epochs == 9 and got.data.batch_size == 2
    assert got.train.resume_ckpt_filepath == os.path.join(
        run_dir, "checkpoints", "ckpt_resume.pt")
    assert want.train.resume_ckpt_filepath == os.path.join(
        run_dir, "checkpoints", "ckpt_resume.msgpack")
    for section, port_cls, jax_cls in SECTIONS:
        common = ({f.name for f in dataclasses.fields(port_cls)}
                  & {f.name for f in dataclasses.fields(jax_cls)})
        for name in sorted(common - {"resume_ckpt_filepath"}):
            assert (getattr(getattr(got, section), name)
                    == getattr(getattr(want, section), name)), name


def test_resume_continues_a_run(tmp_path, capsys):
    """A 1-epoch run, then `resume <run_dir> --n-epochs 2`: a new run
    directory that starts at epoch 1 from the first run's checkpoint."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        argv = ["--device", "cpu", "--dataset", "synthetic",
                "--rgb-encoder-backbone", "resnet18",
                "--depth-encoder-backbone", "resnet18", "--input-height",
                "32", "--input-width", "32", "--batch-size", "2",
                "--synthetic-n-samples", "2", "--n-epochs", "1",
                "--n-workers", "1", "--skip-sanity-check",
                "--class-weighting", "none", "--results-basepath",
                str(tmp_path)]
        assert trainer.main(argv) == 0
        (first,) = os.listdir(tmp_path / "synthetic")
        first = str(tmp_path / "synthetic" / first)
        capsys.readouterr()
        assert trainer.main(["resume", first, "--n-epochs", "2"]) == 0
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["epoch"] == 1
    (second,) = set(os.listdir(tmp_path / "synthetic")) - {
        os.path.basename(first)}
    with open(tmp_path / "synthetic" / second / "argsv.txt") as fh:
        assert fh.read().endswith(
            f"--resume-ckpt-filepath {first}/checkpoints/ckpt_resume.pt "
            "--n-epochs 2")
