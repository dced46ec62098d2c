"""The ranks' side of tests/test_torch_port_parallel.py.

Spawned ranks (`emsanet_tpu_torch.parallel.mesh.launch`) import this
file to find their function, so it imports neither JAX nor the JAX
package. Configuration: the R18 flagship (semantic, instance,
orientation, scene, panoptic) at 64x96, dropout 0, fused training with
`nbt1d_train.MIN_PIXELS` = 0 (every NBt1D tail through the pairs' plain
versions), global batch 8 (4 a rank, as the one-device step test's b4).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.emsanet import EMSANet
from emsanet_tpu_torch.ops import nbt1d_train
from emsanet_tpu_torch.parallel import mesh as mesh_ops
from emsanet_tpu_torch.training.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from emsanet_tpu_torch.training.optim import get_optimizer
from emsanet_tpu_torch.training.step import (
    extract_device_batch,
    make_train_step,
)

H, W = 64, 96
B = 8  # global batch
TASKS = ("semantic", "instance", "orientation", "scene")
NO_DROPOUT = dict(dropout_p=0.0, semantic_decoder_block_dropout_p=0.0,
                  instance_decoder_block_dropout_p=0.0)


def model_kwargs(dtype: str = "float32") -> Dict[str, Any]:
    return dict(tasks=TASKS, enable_panoptic=True, input_height=H,
                input_width=W, rgb_encoder_backbone="resnet18",
                depth_encoder_backbone="resnet18", compute_dtype=dtype,
                semantic_decoder_n_blocks=1, instance_decoder_n_blocks=1,
                **NO_DROPOUT)


def port_cfg(n_devices: int = 2, **data) -> pc.EMSANetConfig:
    return pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(fused_training=True, fused_inference=True,
                             head_decode_fusion="decode-planes",
                             **model_kwargs()),
        data=pc.DataConfig(dataset="synthetic", batch_size=B,
                           n_workers=1, **data),
        train=pc.TrainConfig(n_devices=n_devices)))


def build_model(cfg, state: Dict[str, np.ndarray],
                f64: bool) -> EMSANet:
    """The train model with `state`'s weights, in f64 where asked (f64
    parameters and activations)."""
    model = EMSANet(cfg.model, get_dataset_config("synthetic"), train=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if f64:
        model = model.double()
        model.compute_dtype = torch.float64
    return model.to(memory_format=torch.channels_last).train()


def device_batch(batch: Dict[str, Any], f64: bool) -> Dict[str, Any]:
    tb = extract_device_batch(batch, "cpu")
    if f64:
        tb = {k: (v.double() if k in ("rgb", "depth") else v)
              for k, v in tb.items()}
    return tb


def host_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().double().numpy().copy()
            for k, v in model.state_dict().items()}


class NoUpdate:
    """An optimizer stand-in for `make_train_step` that leaves the
    gradients in place (the emulation's halves)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.model.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        pass


def train_step(mesh, cfg, state, batch, cw, f64: bool):
    """One step of the rank's rows (all rows without a mesh): (losses,
    state after, the model, its optimizer, the step)."""
    model = build_model(cfg, state, f64)
    opt = get_optimizer(model.parameters(), cfg.train)
    cw_t = torch.from_numpy(cw).to(torch.float64 if f64 else torch.float32)
    step = make_train_step(model, cfg, opt, cw_t, mesh)
    rows = (batch if mesh is None
            else mesh_ops.rank_rows(batch, mesh.rank, mesh.size))
    metrics = step(device_batch(rows, f64))
    return ({k: float(v) for k, v in metrics.items()}, host_state(model),
            model, opt, step)


def rank_cases(mesh, state, batch, cw, ckpt_dir) -> Dict[str, Any]:
    """On every rank: the f32 and f64 data-parallel steps of `batch`, a
    checkpoint round trip after the f32 one (rank 0 saves, every rank
    loads; the next step from the loaded state against the live one),
    and the validation of fresh weights (rank 0's logs)."""
    nbt1d_train.MIN_PIXELS = 0
    cfg = port_cfg()
    out: Dict[str, Any] = {}
    for name, f64 in (("f64", True), ("f32", False)):
        losses, after, model, opt, step = train_step(mesh, cfg, state,
                                                     batch, cw, f64)
        out[name] = (losses, after)
    path = os.path.join(ckpt_dir, "ckpt_resume.pt")
    if mesh.is_main:
        save_checkpoint(path, model, opt, 0, losses)
    mesh.barrier()
    back = build_model(cfg, state, False)
    back_opt = get_optimizer(back.parameters(), cfg.train)
    load_checkpoint(path, back, back_opt)
    rows = device_batch(mesh_ops.rank_rows(batch, mesh.rank, mesh.size),
                        False)
    cw_t = torch.from_numpy(cw)
    live = step(rows)
    resumed = make_train_step(back, cfg, back_opt, cw_t, mesh)(rows)
    got = host_state(back)
    out["resume"] = {
        "losses_equal": {k: float(v) for k, v in live.items()}
        == {k: float(v) for k, v in resumed.items()},
        "state_equal": all(np.array_equal(a, got[k])
                           for k, a in host_state(model).items()),
    }
    run = trainer.setup(valid_cfg(), mesh=mesh)
    out["valid_logs"] = trainer.run_validation(run, 0)
    return out


def emulate_f64(mesh, state, batch, cw):
    """The port's one-process emulation of the 2-rank f64 step: each
    half's forward and backward on its own copy of the model, the
    gradients, running statistics and losses averaged, one optimizer
    step. (losses, state after.) `mesh` (one rank) is not used."""
    nbt1d_train.MIN_PIXELS = 0
    cfg = port_cfg()
    halves = []
    for r in range(2):
        model = build_model(cfg, state, True)
        step = make_train_step(model, cfg, NoUpdate(model),
                               torch.from_numpy(cw).double())
        rows = mesh_ops.rank_rows(batch, r, 2)
        halves.append((model, step(device_batch(rows, True))))
    (m0, l0), (m1, l1) = halves
    with torch.no_grad():
        for p0, p1 in zip(m0.parameters(), m1.parameters()):
            p0.grad = (p0.grad + p1.grad) / 2
        for b0, b1 in zip(m0.buffers(), m1.buffers()):
            b0.copy_((b0 + b1) / 2)
    get_optimizer(m0.parameters(), cfg.train).step()
    return {k: float((l0[k] + l1[k]) / 2) for k in l0}, host_state(m0)


def valid_cfg(n_devices: int = 2) -> pc.EMSANetConfig:
    """Validation over 5 samples in batches of 4: the last global batch
    holds 3 padding rows, rank 0 one real row and rank 1 none."""
    cfg = port_cfg(n_devices, validation_batch_size=4, synthetic_n_samples=5)
    cfg.data.batch_size = 4
    return cfg


def fresh_ckpt_dir(tmp_path_factory) -> str:
    """A new folder for the ranks' checkpoint, under pytest's temporary
    folder (the caller removes the checkpoint once it has read it)."""
    return str(tmp_path_factory.mktemp("parallel_ckpt"))
