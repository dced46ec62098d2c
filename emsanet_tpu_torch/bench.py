"""Throughput of the port on the card: RGB-D frames/s at 640x480.

Counterpart of the repository's `bench.py` for the PyTorch/CUDA port:

    python -m emsanet_tpu_torch.bench --batch-size 8 --with-postprocessing --raw-inputs

It takes `bench.py`'s flags, runs the flagship (R34-NBt1D dual encoder,
semantic + instance + orientation + scene, panoptic) with random weights
from a seed, times whole frames with CUDA events and prints ONE JSON line
{"metric", "value", "unit", "vs_baseline"}, like `bench.py`. It needs a
CUDA device.

The head mode comes from `config.best_head_decode_fusion(batch,
with_postprocessing)`, as the reference `bench.py:82` picks it:
'decode-planes' below batch 16, 'decode' from 16 up, 'interleave'
without postprocessing; `--head-decode-fusion` overrides it. These
thresholds are the reference's own, measured on a TPU; PERF.md records
what the H100 shows per mode. With the config's default
`decoder_megakernel='auto'`, frames at batch <= `ops.decoder_trunk.
MAX_BATCH` (2) compute both decoders' trunks in one launch of the
decoder-trunk kernel; larger batches run the decoders module by module,
as the reference `bench.py` does with its own default.

`--no-fused` runs the model module by module (`fused_inference=False`),
as the reference's flag does (`bench.py:79`); by default the frame runs
through the kernels. `--input-modalities` builds the other encoders
('rgb', 'depth', 'rgbd'); the raw frames then carry only the modalities
the model takes (rgbd: both, normalized on the device and concatenated
by the model).

`build_flagship`, `random_raw_inputs` and `make_frame` are shared with
`chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Tuple

import torch

from emsanet_tpu_torch.config import (
    HEAD_DECODE_FUSIONS,
    ModelConfig,
    best_head_decode_fusion,
    flagship_config,
)
from emsanet_tpu_torch.datasets.metadata import DatasetConfig, get_dataset_config
from emsanet_tpu_torch.models.emsanet import EMSANet, build_model
from emsanet_tpu_torch.ops.device_prep import prepare_inputs_device
from emsanet_tpu_torch.postprocessing import postprocess

BASELINE_FPS = 24.5  # BASELINE.md: Jetson AGX Xavier, TensorRT FP16, b1


def build_flagship(
    height: int = 480, width: int = 640, dtype: str = "bfloat16",
    backbone: str = "resnet34", device: str = "cuda", seed: int = 0,
    head_decode_fusion: str = "decode", decoder_megakernel: str = "auto",
    fused_inference: bool = True, dataset: str = "synthetic", **overrides,
) -> Tuple[EMSANet, ModelConfig, DatasetConfig]:
    """The flagship (or, with `overrides` of ModelConfig fields, another
    model) with random weights from `seed`, for `dataset`'s config;
    `backbone` names every encoder's."""
    cfg = flagship_config(**{
        "input_height": height, "input_width": width,
        "compute_dtype": dtype, "rgb_encoder_backbone": backbone,
        "depth_encoder_backbone": backbone, "rgbd_encoder_backbone": backbone,
        "head_decode_fusion": head_decode_fusion,
        "decoder_megakernel": decoder_megakernel,
        "fused_inference": fused_inference, **overrides})
    ds = get_dataset_config(dataset)
    return build_model(cfg, ds, device=device, seed=seed), cfg, ds


def random_raw_inputs(n: int, h: int, w: int, seed: int, device,
                      modalities=("rgb", "depth")) -> Dict[str, torch.Tensor]:
    """uint8 RGB and uint16 depth (0..9999), drawn on the host from `seed`
    (both always drawn, so a frame's RGB does not depend on
    `modalities`); the ones `modalities` takes ('rgbd' takes both)."""
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randint(0, 256, (n, h, w, 3), generator=g).to(torch.uint8)
    depth = torch.randint(0, 10000, (n, h, w, 1), generator=g).to(
        torch.uint16)
    keep = {"rgb", "depth"} if "rgbd" in modalities else set(modalities)
    return {k: v.to(device) for k, v in (("rgb", rgb), ("depth", depth))
            if k in keep}


def make_frame(model: EMSANet, cfg: ModelConfig, ds: DatasetConfig,
               with_postprocessing: bool = True,
               raw_inputs: bool = True) -> Callable[[Dict], Dict]:
    """One frame: device prep -> forward -> postprocess, in the head mode
    of `cfg` (the one `model` was built with)."""
    device = next(model.parameters()).device
    is_thing = torch.tensor(ds.classes_is_thing, device=device)

    @torch.no_grad()
    def frame(batch: Dict[str, torch.Tensor]) -> Dict:
        if raw_inputs:
            batch = prepare_inputs_device(batch, ds.depth_stats.mean,
                                          ds.depth_stats.std)
        outputs = model(batch)
        if with_postprocessing:
            outputs = postprocess(outputs, is_thing, cfg)
        return outputs

    return frame


def time_cuda(fn: Callable[[], object], warmup: int, runs: int) -> float:
    """Mean milliseconds per call, CUDA events around `runs` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--warmup", type=int, default=20)
    parser.add_argument("--runs", type=int, default=80)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--with-postprocessing", action="store_true")
    parser.add_argument("--raw-inputs", action="store_true")
    parser.add_argument("--quick", action="store_true",
                        help="small config for smoke testing")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--head-decode-fusion", default=None,
                        choices=HEAD_DECODE_FUSIONS,
                        help="head mode (default: best_head_decode_fusion "
                        "of the batch size)")
    parser.add_argument("--no-fused", action="store_true",
                        help="run the model module by module "
                        "(fused_inference=False)")
    parser.add_argument("--input-modalities", nargs="+",
                        default=("rgb", "depth"),
                        choices=("rgb", "depth", "rgbd"))
    args = parser.parse_args(argv)
    if args.quick:
        args.batch_size, args.warmup, args.runs = 2, 2, 5
        args.height, args.width = 96, 128
    if not torch.cuda.is_available():
        raise RuntimeError("emsanet_tpu_torch.bench measures the card: no "
                           "CUDA device")
    mode = args.head_decode_fusion or best_head_decode_fusion(
        args.batch_size, args.with_postprocessing)
    mods = tuple(args.input_modalities)
    model, cfg, ds = build_flagship(
        args.height, args.width, args.dtype,
        "resnet18" if args.quick else "resnet34",
        head_decode_fusion=mode, fused_inference=not args.no_fused,
        input_modalities=mods)
    n, h, w = args.batch_size, args.height, args.width
    if args.raw_inputs:
        batch = random_raw_inputs(n, h, w, 0, "cuda", mods)
    else:
        g = torch.Generator().manual_seed(0)
        batch = {"rgb": torch.randn((n, h, w, 3), generator=g).cuda(),
                 "depth": torch.randn((n, h, w, 1), generator=g).cuda()}
    frame = make_frame(model, cfg, ds, args.with_postprocessing,
                       args.raw_inputs)
    ms = time_cuda(lambda: frame(batch), args.warmup, args.runs)
    fps = n / (ms / 1e3)
    print(json.dumps({
        "metric": ("rgbd_frames_per_sec_per_chip_640x480_bf16"
                   if not args.quick else "rgbd_fps_quick_smoke"),
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }))
    print(f"# batch={n} dtype={args.dtype} postproc="
          f"{args.with_postprocessing} head_decode_fusion={mode} "
          f"fused={not args.no_fused} modalities={','.join(mods)} "
          f"latency/batch={ms:.3f}ms "
          f"device={torch.cuda.get_device_name(0)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
