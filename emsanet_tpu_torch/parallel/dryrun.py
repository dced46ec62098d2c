"""Data-parallel dry run of the flagship (counterpart:
`__graft_entry__.py::dryrun_multichip`).

    python -m emsanet_tpu_torch.parallel.dryrun 2 [--device cpu]

`dryrun_multichip(n, device)` does what the JAX package's dry run does,
over n ranks (`parallel/mesh.py`): train steps of the flagship topology
(R34-NBt1D dual encoder, every task, panoptic, `fused_training`) on the
synthetic dataset, the global batch split over the ranks; the sharded
validation with the whole postprocessing; a checkpoint round trip and a
further step. It checks, on every rank:

- every loss is finite; the parameters and the float buffers (the
  BatchNorm running statistics) are bit-identical across the ranks after
  every step (a SHA-256 of their bytes);
- rank 0's validation logs equal, and the eval step's maps (integer
  maps bit for bit) equal, those of one process that evaluates the same
  weights on the same images in calls of the same images
  (`one_process_config`: validation batch B / n);
- a checkpoint that rank 0 saved and every rank loaded holds the live
  parameters, buffers and optimizer state bit for bit, and the next
  step's losses from it equal the live state's (its parameters after
  that step differ by the backward's own run-to-run spread on the card:
  `adaptive_avg_pool2d` and the antialiased bilinear resize, the PPM's,
  have no deterministic CUDA backward; `param_max_abs` reports it).

With fewer cards than ranks the ranks share card 0 over gloo, as the JAX
package's dry run takes a virtual mesh when the backend has too few
devices (`__graft_entry__.py:80-98`); the trainer keeps the hard check.
`world1_check` runs one rank over NCCL (the one-card-per-rank backend):
its step equals the plain one-process step (the first step's losses bit
for bit; after the steps its parameters lie no farther from the closest
of three plain runs than the farthest two plain runs lie apart).
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import math
import os
import sys
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

from emsanet_tpu_torch.export_model import compare_outputs
from emsanet_tpu_torch.parallel import mesh as mesh_ops

TIMEOUT_S = 900  # for the ranks of a dry run
TRAIN_KERNELS = (("ops.nbt1d_train", "pair_fwd"),
                 ("ops.nbt1d_train", "pair_bwd"),
                 ("ops.semantic_train_head", "head_loss_fwd"),
                 ("ops.semantic_train_head", "head_loss_bwd"))
EVAL_KERNELS = (("ops.stem", "fused_stems"),
                ("ops.nbt1d_chain", "nbt1d_chain"),
                ("ops.grouping", "group_pixels_argmin"),
                ("ops.segment_kernels", "segment_hist_and_sums"),
                ("ops.segment_kernels", "segment_lookup"),
                ("ops.semantic_decode", "semantic_decode"),
                ("ops.instance_head", "instance_head"),
                ("ops.plane_interleave", "interleave_planes"))


def _counter(path: str, name: str):
    import importlib

    return getattr(importlib.import_module(f"emsanet_tpu_torch.{path}"),
                   name)


def launch_counts(kernels) -> Dict[str, int]:
    return {name: _counter(path, name).launches for path, name in kernels}


def reset_counts(kernels) -> None:
    for path, name in kernels:
        _counter(path, name).launches = 0


def flagship_train_config(height: int, width: int, batch_size: int,
                          n_samples: int, backbone: str = "resnet34",
                          n_devices: int = 1):
    """The flagship's training configuration on the synthetic dataset:
    every task, panoptic, bf16 compute, fused training and inference,
    'decode-planes' heads, the given global batch for training and
    validation."""
    from emsanet_tpu_torch import config as pc

    return pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(
            tasks=("semantic", "instance", "orientation", "scene"),
            enable_panoptic=True, input_height=height, input_width=width,
            rgb_encoder_backbone=backbone, depth_encoder_backbone=backbone,
            compute_dtype="bfloat16", fused_training=True,
            fused_inference=True, head_decode_fusion="decode-planes"),
        data=pc.DataConfig(dataset="synthetic", batch_size=batch_size,
                           validation_batch_size=batch_size,
                           synthetic_n_samples=n_samples, n_workers=4),
        train=pc.TrainConfig(n_devices=n_devices)))


def state_digest(model: torch.nn.Module) -> str:
    """SHA-256 of the bytes of every parameter and float buffer (f32:
    the training model's)."""
    h = hashlib.sha256()
    with torch.no_grad():
        for t in [*model.parameters(),
                  *(b for b in model.buffers() if b.is_floating_point())]:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _TimedReduce:
    """Wraps `training.step.all_mean_` to add up its wall seconds (the
    device synchronized before and after)."""

    def __init__(self, device: torch.device):
        from emsanet_tpu_torch.training import step as step_mod

        self.step_mod, self.orig = step_mod, step_mod.all_mean_
        self.device, self.seconds = device, 0.0

    def __enter__(self):
        def timed(mesh, tensors):
            _sync(self.device)
            t0 = time.perf_counter()
            self.orig(mesh, tensors)
            _sync(self.device)
            self.seconds += time.perf_counter() - t0

        self.step_mod.all_mean_ = timed
        return self

    def __exit__(self, *exc):
        self.step_mod.all_mean_ = self.orig


def _tensors(preds: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in preds.items()}


def compare_logs(got: Dict[str, float], want: Dict[str, float]) -> List[str]:
    """The validation logs' keys whose values differ (NaN equals NaN)."""
    def same(a, b):
        return a == b or (isinstance(a, float) and isinstance(b, float)
                          and math.isnan(a) and math.isnan(b))

    return [k for k in sorted(set(got) | set(want))
            if k not in got or k not in want or not same(got[k], want[k])]


def one_process_config(cfg, n_devices: int):
    """The configuration of one process that evaluates every image in a
    call of the same images as a rank of `n_devices` does: validation
    batch B / n. An image's outputs depend on the batch its convolutions
    and kernels run in (cuDNN's algorithm, a kernel's split of the work),
    so only then must one process's logs equal the ranks'."""
    one = copy.deepcopy(cfg)
    one.data.validation_batch_size = cfg.data.validation_batch_size // n_devices
    one.train.n_devices = 1
    return one


def _dryrun_rank(mesh: mesh_ops.Mesh, cfg, steps: int) -> Dict[str, Any]:
    from emsanet_tpu_torch import train as trainer
    from emsanet_tpu_torch.training.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from emsanet_tpu_torch.training.step import extract_device_batch

    dev, seed = mesh.device, cfg.train.seed
    run = trainer.setup(cfg, mesh=mesh)
    trainer.replicate(run)
    loader = run.data.train_loader
    batches = [extract_device_batch(b, dev)
               for _, b in zip(range(steps), loader.batches(0))]
    report: Dict[str, Any] = {"rank": mesh.rank, "losses": [],
                              "step_s": [], "digests": []}
    reset_counts(TRAIN_KERNELS)
    with _TimedReduce(dev) as reduce:
        for i, b in enumerate(batches):
            _sync(dev)
            t0 = time.perf_counter()
            m = run.train_step(b, trainer.dropout_generator_for(seed, 0, i,
                                                                dev))
            _sync(dev)
            report["step_s"].append(time.perf_counter() - t0)
            report["losses"].append({k: float(v) for k, v in m.items()})
            report["digests"].append(state_digest(run.model))
    report["reduce_s"] = reduce.seconds
    report["train_launches"] = launch_counts(TRAIN_KERNELS)

    # sharded validation against one process on rank 0 that evaluates the
    # same images in the same calls
    def keep(kept: List[Dict]):
        # the predictions of a batch's real rows
        return lambda b, p: kept.append(
            {k: v[b["_valid_mask"]] for k, v in p.items()})

    reset_counts(EVAL_KERNELS)
    sharded: List[Dict] = []
    logs = trainer.run_validation(run, 0, on_batch=keep(sharded))
    report["eval_launches"] = launch_counts(EVAL_KERNELS)
    if mesh.is_main:
        one = trainer.setup(one_process_config(cfg, mesh.size), dev)
        one.model.load_state_dict(run.model.state_dict())
        single: List[Dict] = []
        one_logs = trainer.run_validation(one, 0, on_batch=keep(single))
        one.data.close()
        report["valid_logs"] = logs
        report["valid_logs_unequal"] = compare_logs(logs, one_logs)
        report["valid_maps_unequal"] = compare_outputs(
            _tensors(mesh_ops.concat_rows(sharded)),
            _tensors(mesh_ops.concat_rows(single)), atol=0.0)["failed"]
        del one

    # checkpoint round trip: rank 0 saves, every rank loads; the loaded
    # state against the live one, and one more step from each
    path = mesh_ops.broadcast_object(
        mesh, tempfile.mkdtemp(prefix="emsanet_ckpt_")
        if mesh.is_main else None)
    ckpt = os.path.join(path, "ckpt_resume.pt")
    if mesh.is_main:
        save_checkpoint(ckpt, run.model, run.optimizer, 0,
                        report["losses"][-1])
    mesh.barrier()
    from emsanet_tpu_torch.models.emsanet import build_train_model
    from emsanet_tpu_torch.training.optim import get_optimizer
    from emsanet_tpu_torch.training.step import make_train_step

    model = build_train_model(cfg.model, run.ds_config, device=str(dev),
                              seed=None)
    optimizer = get_optimizer(model.parameters(), cfg.train)
    load_checkpoint(ckpt, model, optimizer)
    mesh.barrier()
    if mesh.is_main:
        import shutil

        shutil.rmtree(path, ignore_errors=True)
    state_equal = (state_digest(run.model) == state_digest(model)
                   and _optimizer_states_equal(run.optimizer, optimizer))
    restored = make_train_step(model, cfg, optimizer, run.class_weights,
                               mesh)
    g = steps  # the next step's dropout generator
    m_back = restored(batches[0],
                      trainer.dropout_generator_for(seed, 0, g, dev))
    m_live = run.train_step(batches[0],
                            trainer.dropout_generator_for(seed, 0, g, dev))
    report["resume"] = {
        "state_equal": state_equal,
        "losses_equal": all(float(m_live[k]) == float(m_back[k])
                            for k in m_live),
        "param_max_abs": _max_abs(model, run.model)}
    report["digests"].append(state_digest(run.model))
    report["losses"].append({k: float(v) for k, v in m_live.items()})
    run.data.close()
    return report


def _optimizer_states_equal(a: torch.optim.Optimizer,
                            b: torch.optim.Optimizer) -> bool:
    sa, sb = a.state_dict()["state"], b.state_dict()["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], sb[i][k]) if torch.is_tensor(sa[i][k])
        else sa[i][k] == sb[i][k] for i in sa for k in sa[i])


def _max_abs(a: torch.nn.Module, b: torch.nn.Module) -> float:
    """The largest difference of two models' parameters and buffers."""
    sb = b.state_dict()
    return max(float((v.float() - sb[k].float()).abs().max())
               for k, v in a.state_dict().items() if v.is_floating_point())


def _world1_rank(mesh: mesh_ops.Mesh, cfg, steps: int) -> Dict[str, Any]:
    """World size 1 through the data-parallel step, against three runs of
    the plain one-process step, all from the same weights and batches."""
    from emsanet_tpu_torch import train as trainer
    from emsanet_tpu_torch.training.step import (
        extract_device_batch,
        make_train_step,
    )

    dev, seed = mesh.device, cfg.train.seed
    run = trainer.setup(cfg, dev)
    batches = [extract_device_batch(b, dev) for _, b in
               zip(range(steps), run.data.train_loader.batches(0))]
    run.data.close()
    start = ({k: v.clone() for k, v in run.model.state_dict().items()},
             copy.deepcopy(run.optimizer.state_dict()))

    def trial(step) -> Dict[str, Any]:
        run.model.load_state_dict(start[0])
        run.optimizer.load_state_dict(start[1])
        losses, secs = [], []
        for i, b in enumerate(batches):
            _sync(dev)
            t0 = time.perf_counter()
            out = step(b, trainer.dropout_generator_for(seed, 0, i, dev))
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in out.items()})
        params = {k: v.detach().float().clone()
                  for k, v in run.model.state_dict().items()
                  if v.is_floating_point()}
        return {"losses": losses, "params": params, "step_s": secs}

    ranked = trial(make_train_step(run.model, cfg, run.optimizer,
                                   run.class_weights, mesh))
    plain = [trial(run.train_step) for _ in range(3)]

    def max_diff(x, y):
        return max(float((x["params"][k] - y["params"][k]).abs().max())
                   for k in x["params"])

    return {
        "backend": torch.distributed.get_backend(),
        "first_step_equal": ranked["losses"][0] == plain[0]["losses"][0],
        # the closest plain run, and the farthest two plain runs
        "param_diff_mesh": min(max_diff(ranked, p) for p in plain),
        "param_diff_plain": max(max_diff(plain[i], plain[j])
                                for i in range(3) for j in range(i)),
        "losses_finite": all(math.isfinite(v) for step in ranked["losses"]
                             for v in step.values()),
        "step_s_mesh": ranked["step_s"], "step_s_plain": plain[0]["step_s"],
    }


def _check_reports(reports: List[Dict]) -> None:
    steps = len(reports[0]["digests"])
    for i in range(steps):
        digests = {r["digests"][i] for r in reports}
        if len(digests) != 1:
            raise AssertionError(f"step {i}: the ranks' parameters differ")
    for r in reports:
        bad = [v for step in r["losses"] for v in step.values()
               if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"rank {r['rank']}: non-finite loss {bad}")
        if not (r["resume"]["state_equal"] and r["resume"]["losses_equal"]):
            raise AssertionError(f"rank {r['rank']}: the loaded checkpoint "
                                 f"differs from the live state: "
                                 f"{r['resume']}")
    main = reports[0]
    if main["valid_logs_unequal"]:
        raise AssertionError(f"the sharded validation's logs differ from "
                             f"one process's at {main['valid_logs_unequal']}")
    if main["valid_maps_unequal"]:
        raise AssertionError(f"the sharded eval's maps differ: "
                             f"{main['valid_maps_unequal']}")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     height: int = 480, width: int = 640, steps: int = 3,
                     backbone: str = "resnet34") -> Dict[str, Any]:
    """Train, validate and resume over `n_devices` ranks (the checks in
    the module's docstring; an AssertionError names the first that
    fails), at a global batch of 4 a rank.
    Returns rank 0's report: losses, digests, step and all-reduce
    seconds, the validation's logs and map comparison, and every rank's
    launch counts of the train kernels (9, 10) over the steps and of the
    eval kernels (1-7) over the validation (`all_launches`: which run
    depends on the gates at the shapes given)."""
    batch_size = 4 * n_devices
    cfg = flagship_train_config(height, width, batch_size,
                                max(steps, 1) * batch_size, backbone,
                                n_devices)
    shared = (device == "cuda"
              and mesh_ops.available_devices("cuda") < n_devices)
    reports = mesh_ops.launch(_dryrun_rank, n_devices, device, cfg, steps,
                              shared_card=shared, timeout=TIMEOUT_S)
    _check_reports(reports)
    main = reports[0]
    backend = mesh_ops.backend_for(device, shared)
    print(f"dryrun_multichip({n_devices}, {device}, {backend}"
          f"{', one shared card' if shared else ''}): train total_loss "
          f"{main['losses'][0]['total_loss']:.4f} -> "
          f"{main['losses'][-1]['total_loss']:.4f}, replicas bit-identical "
          f"over {steps} steps OK")
    print(f"dryrun_multichip({n_devices}): sharded eval + postprocess "
          f"equals one process (logs, maps) OK")
    print(f"dryrun_multichip({n_devices}): ckpt round trip OK (the next "
          f"step's parameters {main['resume']['param_max_abs']:.3g} from "
          f"the live step's)")
    main["all_launches"] = [{**r["train_launches"], **r["eval_launches"]}
                            for r in reports]
    return main


def world1_check(device: str = "cuda", height: int = 480, width: int = 640,
                 batch_size: int = 8, steps: int = 3,
                 backbone: str = "resnet34") -> Dict[str, Any]:
    """One rank through the data-parallel step (NCCL on the card, gloo on
    the CPU): its first step's losses equal the plain step's bit for bit,
    and after `steps` steps its parameters differ from the closest of
    three plain runs by no more than the farthest two plain runs differ
    from each other (the step's backward is not deterministic on the
    card)."""
    cfg = flagship_train_config(height, width, batch_size,
                                steps * batch_size, backbone)
    (rep,) = mesh_ops.launch(_world1_rank, 1, device, cfg, steps,
                             timeout=TIMEOUT_S)
    if not rep["first_step_equal"]:
        raise AssertionError("world size 1: the first step's losses differ "
                             "from the plain step's")
    if rep["param_diff_mesh"] > rep["param_diff_plain"]:
        raise AssertionError(
            f"world size 1: parameters {rep['param_diff_mesh']:.3g} from the "
            f"plain run's, two plain runs {rep['param_diff_plain']:.3g}")
    if not rep["losses_finite"]:
        raise AssertionError("world size 1: a non-finite loss")
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--backbone", default="resnet34")
    p.add_argument("--steps", type=int, default=3)
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    dryrun_multichip(a.n_devices, a.device, a.height, a.width,
                     steps=a.steps, backbone=a.backbone)
    return 0


if __name__ == "__main__":
    sys.exit(main())
