"""The inference scripts on the card against the same runs on the CPU.

Marked `cuda`: they skip without a GPU. This file imports no JAX; on the
card:

    python -m pytest tests/test_torch_cuda_inference.py -m cuda -q

Model: R18 encoders, 96x128, semantic + instance + orientation + scene,
panoptic, f32 (TF32 off), with the seeded random weights of
`models.emsanet.build_model` saved as a port checkpoint. Files: two
Kinect-style sample pairs (480x640 and 540x960) and a prepared dataset
of two cameras (96x128 and 106x146) written by the port's PNG writer.
Limits: `tests/torch_inference_cases.py` (phase 8's).
"""

import os
import sys
from pathlib import Path

import pytest
import torch
import torch_inference_cases as cases

from emsanet_tpu_torch import inference_dataset, inference_samples
from emsanet_tpu_torch.config import flagship_config
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.emsanet import build_model
from emsanet_tpu_torch.training.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    _need_cuda()
    tmp = tmp_path_factory.mktemp("cuda_inference")
    samples = str(tmp / "samples")
    names = cases.write_samples(samples, ((480, 640), (540, 960)))
    dataset = str(tmp / "dataset")
    chip_smoke.write_prepared(dataset, 2, chip_smoke.SMALL_CAMERAS, 2)
    model = build_model(flagship_config(
        input_height=96, input_width=128, rgb_encoder_backbone="resnet18",
        depth_encoder_backbone="resnet18", compute_dtype="float32"),
        get_dataset_config("synthetic"), device="cpu", seed=0)
    ckpt = str(tmp / "small.pt")
    save_checkpoint(ckpt, model, None, 0)
    return {"tmp": tmp, "samples": samples, "names": names,
            "dataset": dataset, "ckpt": ckpt}


def _flags(files, device):
    return ["--device", device, "--dataset", "nyuv2", "--dataset-path",
            files["dataset"], *cases.SMALL_FLAGS, "--raw-depth",
            "--n-workers", "2", "--weights-filepath", files["ckpt"]]


@pytest.mark.cuda
def test_cuda_sample_inference_matches_cpu(files):
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = str(files["tmp"] / f"panels_{device}")
        inference_samples.run(_flags(files, device) + [
            "--sample-path", files["samples"], "--depth-max", "8000",
            "--output-path", out[device]])
    cases.compare_panels(out["cuda"], out["cpu"], files["names"], 96, 128)


@pytest.mark.cuda
def test_cuda_dataset_inference_matches_cpu(files):
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = str(files["tmp"] / f"dataset_{device}")
        inference_dataset.run(_flags(files, device) + [
            "--batch-size", "2", "--head-decode-fusion", "auto",
            "--inference-output-path", out[device],
            "--inference-output-format", *inference_dataset.FORMATS,
            "--inference-output-fullres"])
    report = cases.compare_dataset_outputs(out["cuda"], out["cpu"])
    assert report["files"] > 4 * 2
    assert cases.read_back(out["cuda"])["semantic"] == 4
    assert os.path.exists(os.path.join(out["cuda"], "meta.json"))
