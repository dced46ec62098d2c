#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build: compile every kernel of `emsanet_tpu_torch/csrc` (one nvcc per
     source, all at once); `ptxas` must give both instantiations (bf16,
     f32) of the head-loss forward and backward kernels, the decoder
     trunk kernel, the stem kernel and the semantic decode kernel a
     0-byte stack frame; their registers and shared memory are logged.
     The bf16 stem's SASS (`cuobjdump -sass` of the built library) must
     hold tensor-core instructions (HMMA or HGMMA).
  2. main path, per head mode (`interleave`, `decode`, `decode-both`,
     `decode-planes`): the flagship frame (R34-NBt1D dual encoder,
     semantic + instance + orientation + scene, panoptic; 640x480, bf16,
     random weights from seed 0; raw uint8/uint16 inputs -> device prep ->
     forward -> postprocess) at batch 1 and batch 8, with every launch
     counter set to 0 just before the mode's two frames and read just
     after; each kernel on the mode's path must have launched. With the
     default decoder_megakernel='auto' the b1 frame runs both decoders'
     trunks in one decoder_trunk launch, the b8 frame its decoders module
     by module (chain kernel). The kernels' inputs are captured on the
     way.
  3. kernels vs plain: every kernel against its plain PyTorch version on
     the captured inputs of every mode, in bf16 and again in f32 (TF32
     off), with the tolerances below. The stem and the semantic decode
     must give the same bits in two calls on each of the decode-planes
     b8 frame's inputs.
  4. outputs: finite values of the expected shapes; a small b2 frame
     (96x128, R18, f32; no head defers there), once with 'auto' (the
     card takes the trunk kernel, the CPU the unfused decoders) and once
     with 'on' (the CPU takes the trunk's plain version), and a 128x160
     R18 f32 frame in `decode-planes` and in `decode-both` (the heads
     defer: the final x2 stage's input, 64x80, passes the 60*80
     polyphase gate) on the card agree with the same frames run by the
     plain versions on the CPU, on at least 0.99 of the pixels of each
     postprocessed map; each card frame launches the trunk once. Logged, not
     gated: the share of b8 pixels (and of center slots) where the
     `decode*` modes and `interleave` agree. They may legitimately differ:
     the random weights saturate the center heatmap, and its tied
     plateaus break by mode (bf16 or f32 sigmoid, row-major or
     parity-major top-k order).
  5. timing: each mode's frame at b1 and b8 (the median of 5 rounds over
     the modes in turn), and each kernel, its plain version and its
     library yardstick, with CUDA events, on the captured
     inputs of `decode-planes` (the mode `emsanet_tpu_torch.bench` picks
     below batch 16); the interleaved variants of the semantic decode and
     instance head kernels on those of `decode` / `decode-both`.
 5b. the trunk on vs off (logged, not gated): the decode-planes frame
     at b1, b2 and b8 with the trunk kernel ('auto' at b1 and b2, 'on'
     at b8) against 'off': frame ms (median of 5 rounds, the two in
     alternating order), device busy ms and device kernels per frame
     under torch.profiler; the trunk kernel's ms, plain ms and bound at
     b2 and b8 (its b1 numbers are those of phase 5). Gated: the bf16
     trunk repeats bit for bit on the b1 and b2 frames' inputs. Logged: the
     kernel's 42 phases (%globaltimer stamps: each phase's work, and its
     wait at the grid barrier) at b1 and on a 2x2 context with the
     flagship's weights (the fixed cost).
  6. profile: each mode's frame at b1 and at b8 under torch.profiler;
     device time by kernel name, the device's busy share of the profiled
     and of the timed frame, and whether ATen's depthwise conv kernel
     still runs (chip_smoke_profile.txt in OUT_DIR); every profiled frame
     must run the chain's wgmma kernels (the C = 64 and 128 pairs and the
     wider sites' conv) and not the first design's `conv3tap_tc_kernel`,
     and every profiled b1 frame the bf16 trunk kernel (torch.profiler
     now and then drops a kernel's records: a frame whose trace lacks a
     required kernel is profiled again, up to PROFILE_ATTEMPTS times); the
     device time of each kernel that has a library yardstick beside that
     call's; every kernel's device time at b1 and b8 on the calls that
     give its "ms_b1" / "ms_b8".
 6b. chain sites (logged): one line per chain call of the decode-planes
     b1 and b8 frames: C, map, batch, blocks, pair launches, wrapper and
     device ms, bound, TFLOP/s, and cuDNN's convs alone (F.conv2d 3x1
     then 1x3, channels_last bf16, no epilogue; a yardstick the port
     never calls). Gated: each b1 call repeats bit for bit.
  7. train: the flagship training step (R34-NBt1D, semantic + instance +
     orientation + scene, NYUv2 labels; 640x480, b8, bf16 compute with f32
     parameters, fused_training, multiscale supervision, median-frequency
     class weights, SGD Nesterov at lr 0.01, the config's dropout) on one
     batch of the synthetic dataset from the train preprocessor, already
     on the device: 3 steps with the launch counters set to 0 before them;
     each of the four train kernels must launch (the pairs 12 times per
     step, and the profiled step must run each of their tensor-core
     kernels 12 times), every loss be finite and the last total below
     the first. The kernels' inputs of the first step are captured and
     each train kernel is held against its plain version on them, in
     bf16 and in f32 (TF32 off); the head-loss forward's sums and the
     backward must repeat bit for bit. The model starts from the reference's initialization
     (`weights.reference_init_`), as `python -m emsanet_tpu_torch.train`
     does. A 96x128 R18 f32 b4 step (dropout 0,
     every NBt1D tail through the pairs) runs on the card and on the CPU
     from the same weights and batch. Timing: the b8 step
     (median and range of rounds, CUDA events), its device busy share
     under torch.profiler (a step whose trace lacks launches of the pair
     kernels is profiled again, as the frames are), each train kernel, its plain version and its
     bound; the loader's host time per batch.

Tolerances (error relative to the largest magnitude of the plain result
unless stated): stem bf16 2e-2, f32 1e-4; NBt1D chain bf16 5e-2 (K
blocks; the plain version rounds every conv output to bf16, the kernel
only the conv pair's intermediate), f32 1e-4; grouping index and
distance bit-exact; histogram exact; vector sums 1e-4 (f32 atomics in
varying order); lookup exact; semantic decode f32 index exact and score
1e-5 relative, bf16 index different on at most 1e-4 of the pixels and
only where the plain version's top two values are within one bf16 ulp,
score 1e-2 absolute where the index agrees; instance head f32 1e-5, bf16
2e-2; plane interleave bit-exact; decoder trunk bf16 5e-2 (42 convs
in 3 modules at the flagship; kernel and plain version round at the
same points, but an f32 sum taken in another order can flip a bf16
rounding, and the flip carries through the later layers, as in the
chain), f32 1e-4. Train kernels: NBt1D pair forward y bf16 5e-2 / f32 1e-4 and sums 1e-4; backward every gradient bf16 5e-2 /
f32 1e-3: the weight and vector gradients relative to the largest sum
of the magnitudes of the terms they add up (on the main path's data they
are sums over 153600 pixels that cancel; gb13 feeds the next BatchNorm
and is zero up to rounding), gu relative to its max over all but the 1e-3
share of elements with the largest errors (a ReLU mask can flip where a
pre-activation lies within rounding of 0, and each flip moves the 3 x C
elements of gu it reaches by up to their full size); the error relative
to each output's max is logged per output, not gated (on the cancelling
sums, and on gu where a flip moves a few elements, it lies far above the
gated error; PERF.md gives both);
semantic head loss bf16 1e-2 / f32 1e-5 (the kernel rounds the
summed polyphase taps, the plain conv each 3x3 tap), dx 5e-2 / 1e-4,
dweight 5e-2 / 1e-3. Small train step, card vs CPU: losses 1e-4
relative, BatchNorm running statistics atol 1e-4 / rtol 1e-3; the
parameter updates (and gradients) by the relative norm of their
difference, < 5e-2 over all and < 0.5 per tensor: an f32 gradient of
this network moves by ~1e-2 when its input moves by 1e-6
(tests/test_torch_port_train.py), so element-wise bounds on them would
measure that, not the kernels.

Output: progress lines (also written to chiprun_out/chip_smoke.log), the
card's name and power limit, one JSON line
{"kernels": [...]} (each entry's "ms" at the batch it names: b8, and b1
for the trunk, which the 'auto' gate runs only there; beside it
"ms_b1" / "ms_b8", the wrapper's CUDA-event ms at each batch, and
"device_ms_b1" / "device_ms_b8", torch.profiler's device ms of the same
calls; the trunk's b8 numbers are phase 5b's 'on' call; the train
kernels run at b8 only, their b1 keys are null and their b8 device ms
comes from the profiled step) and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor, f32 FMA
BATCHES = (1, 8)
MODES = ("interleave", "decode", "decode-both", "decode-planes")
TIMING_MODE = "decode-planes"
FRAME_ROUNDS = 5
KERNELS = (
    ("fused_stems", "stem", "emsanet_tpu_torch/csrc/stem.cu",
     "emsanet_tpu/ops/stem.py:348"),
    ("nbt1d_chain", "nbt1d_chain", "emsanet_tpu_torch/csrc/nbt1d_chain.cu",
     "emsanet_tpu/ops/nbt1d_chain.py:434"),
    ("group_pixels_argmin", "grouping", "emsanet_tpu_torch/csrc/grouping.cu",
     "emsanet_tpu/ops/grouping.py:99"),
    ("segment_hist_and_sums", "segment_kernels",
     "emsanet_tpu_torch/csrc/segment.cu",
     "emsanet_tpu/ops/segment_pallas.py:102"),
    ("segment_lookup", "segment_kernels", "emsanet_tpu_torch/csrc/segment.cu",
     "emsanet_tpu/ops/segment_pallas.py:165"),
    ("semantic_decode", "semantic_decode",
     "emsanet_tpu_torch/csrc/semantic_decode.cu",
     "emsanet_tpu/ops/semantic_decode.py:311"),
    ("instance_head", "instance_head",
     "emsanet_tpu_torch/csrc/instance_head.cu",
     "emsanet_tpu/ops/instance_head.py:289"),
    ("interleave_planes", "plane_interleave",
     "emsanet_tpu_torch/csrc/plane_interleave.cu",
     "emsanet_tpu/ops/plane_interleave.py:85"),
    ("decoder_trunk", "decoder_trunk",
     "emsanet_tpu_torch/csrc/decoder_trunk.cu",
     "emsanet_tpu/ops/decoder_trunk.py:638"),
)
# with the default decoder_megakernel='auto', every mode's b1 frame runs
# both decoders' trunks in one decoder_trunk launch; at b8 the decoders
# run their modules through the chain kernel
COMMON = {"fused_stems", "nbt1d_chain", "group_pixels_argmin",
          "segment_hist_and_sums", "segment_lookup", "decoder_trunk"}
PATH_KERNELS = {  # the kernels each mode's frame must launch
    "interleave": COMMON,
    "decode": COMMON | {"semantic_decode"},
    "decode-both": COMMON | {"semantic_decode", "instance_head"},
    "decode-planes": COMMON | {"semantic_decode", "instance_head",
                               "interleave_planes"},
}
NEW_KERNELS = {"semantic_decode", "instance_head", "interleave_planes"}
# the batch whose captured calls give a kernel's "ms": b8, except for the
# trunk, which the 'auto' gate runs at b1 only
ENTRY_BATCH = {"decoder_trunk": 1}
TRUNK_BATCHES = (1, 2, 8)  # the trunk on vs off: 'auto' at b1 / b2, 'on' at b8
# the training step's kernels: (wrapper, module, source, TPU kernel)
TRAIN_KERNELS = (
    ("pair_fwd", "nbt1d_train", "emsanet_tpu_torch/csrc/nbt1d_train.cu",
     "emsanet_tpu/ops/nbt1d_train.py:536"),
    ("pair_bwd", "nbt1d_train", "emsanet_tpu_torch/csrc/nbt1d_train.cu",
     "emsanet_tpu/ops/nbt1d_train.py:619"),
    ("head_loss_fwd", "semantic_train_head",
     "emsanet_tpu_torch/csrc/semantic_train_head.cu",
     "emsanet_tpu/ops/semantic_train_head.py:490"),
    ("head_loss_bwd", "semantic_train_head",
     "emsanet_tpu_torch/csrc/semantic_train_head.cu",
     "emsanet_tpu/ops/semantic_train_head.py:536"),
)
TRAIN_NAMES = {"pair_fwd": "nbt1d_pair_fwd", "pair_bwd": "nbt1d_pair_bwd",
               "head_loss_fwd": "semantic_head_loss_fwd",
               "head_loss_bwd": "semantic_head_loss_bwd"}
TRAIN_STEPS = 3
TRAIN_ROUNDS = 5
# pair calls per flagship step: the two encoders' stage-1 tails, 3 NBt1D
# blocks of 2 pairs each (the only sites past the MIN_PIXELS gate)
PAIR_CALLS_PER_STEP = 12
# the device kernels behind each pair wrapper in bf16 (csrc/nbt1d_train.cu)
PAIR_DEVICE_KERNELS = {"pair_fwd": ("pair_fwd_tc",),
                       "pair_bwd": ("pair_bwd_dy_tc", "pair_bwd_du_tc",
                                    "pair_wgrad_tc")}
# the bf16 chain's device kernels (csrc/nbt1d_chain.cu): the C = 64 and 128
# pairs and the wgmma conv of the wider sites must run in every profiled
# frame, the first design's mma.sync conv in none
CHAIN_DEVICE_KERNELS = ("nbt1d_pair64_kernel", "nbt1d_pair128_kernel",
                        "conv3tap_wgmma_kernel")
OLD_CHAIN_KERNEL = "conv3tap_tc_kernel"
# the bf16 trunk's device kernel, which every profiled b1 frame must run
TRUNK_DEVICE_KERNEL = "decoder_trunk_kernel<__nv_bfloat16>"
# torch.profiler now and then drops a kernel's records from a trace: a
# frame or step whose trace lacks a kernel it must run is profiled again,
# and fails when none of this many traces shows it
PROFILE_ATTEMPTS = 3
# (source, kernel) whose instantiations ptxas must give no stack frame
STACK_FREE = (("semantic_train_head", "head_loss_fwd_kernel"),
              ("semantic_train_head", "head_loss_bwd_kernel"),
              ("decoder_trunk", "decoder_trunk_kernel"),
              ("stem", "stem_kernel"),
              ("semantic_decode", "semantic_decode_kernel"))
# the bf16 stem must run on the tensor cores: its SASS (cuobjdump of the
# built library) must hold mma instructions
TENSOR_CORE_SASS = (("stem", "stem_kernel", "__nv_bfloat16"),)
TENSOR_CORE_OPS = ("HMMA", "HGMMA")
# kernels whose two calls on the flagship b8 frame's inputs must give the
# same bits (no atomics; a fixed order of every sum)
REPEAT_KERNELS = ("fused_stems", "semantic_decode")


LOG_FILE = os.path.join(OUT_DIR, "chip_smoke.log")  # the whole log


def log(msg: str) -> None:
    print(msg, flush=True)
    if os.path.isdir(OUT_DIR):
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# capture of the kernels' inputs on the main path


class Capture:
    """Wraps each kernel wrapper (module attribute) to record its inputs."""

    def __init__(self, modules, kernels=KERNELS):
        self.modules = modules
        self.kernels = kernels
        self.calls = {name: [] for name, *_ in kernels}
        self._orig = {}

    def __enter__(self):
        for name, mod, *_ in self.kernels:
            m = self.modules[mod]
            orig = getattr(m, name)
            self._orig[name] = (m, orig)

            def wrapped(*args, __orig=orig, __name=name, **kwargs):
                self.calls[__name].append((args, kwargs))
                return __orig(*args, **kwargs)

            setattr(m, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (m, orig) in self._orig.items():
            setattr(m, name, orig)


def counts(modules, kernels=KERNELS):
    return {name: getattr(modules[mod], name).launches
            for name, mod, *_ in kernels}


def reset_counts(modules, kernels=KERNELS):
    for name, mod, *_ in kernels:
        getattr(modules[mod], name).launches = 0


# ---------------------------------------------------------------------------
# per-kernel work: plain version, bytes and operations of one call


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _words(named):
    """The maps that `interleave_planes` sends through its kernel."""
    import torch

    return [x for x in named.values()
            if x.dtype in (torch.float32, torch.int32) and x.shape[-1] >= 2]


def kernel_spec(name, args, kwargs, ops_mod):
    """(kernel_fn, plain_fn, library_fn or None, bytes, ops, ops dtype)."""
    import torch
    import torch.nn.functional as F

    stem, chain, grouping, seg, sdec, ihead, pint, trunk = ops_mod
    if name == "fused_stems":
        xs, ws, bns = args
        outs_b = sum(x.shape[0] * ((x.shape[1] + 3) // 4)
                     * ((x.shape[2] + 3) // 4) * 64 * x.element_size()
                     for x in xs)
        ops = sum(2 * 64 * x.shape[3] * 49 * x.shape[0]
                  * ((x.shape[1] + 1) // 2) * ((x.shape[2] + 1) // 2)
                  for x in xs)
        # the kernel reads its weights in the compute dtype
        byts = (_nbytes(*xs) + outs_b
                + sum(w.numel() * xs[0].element_size() for w in ws))
        return (lambda: stem.fused_stems(xs, ws, bns),
                lambda: stem.fused_stems_plain(xs, ws, bns), None,
                byts, ops, str(xs[0].dtype).split(".")[1])
    if name == "nbt1d_chain":
        x, st = args
        n, h, w, c = x.shape
        k = st["w31"].shape[0]
        byts = 2 * _nbytes(x) + k * 4 * 3 * c * c * x.element_size()
        ops = k * 4 * 3 * c * c * 2 * n * h * w
        return (lambda: chain.nbt1d_chain(x, st),
                lambda: chain.nbt1d_chain_plain(x, st), None,
                byts, ops, str(x.dtype).split(".")[1])
    if name == "group_pixels_argmin":
        voted, centers, valid = args
        n, p, _ = voted.shape
        kk = centers.shape[1]
        byts = _nbytes(voted, centers, valid) + n * p * 8
        return (lambda: grouping.group_pixels_argmin(voted, centers, valid),
                lambda: grouping.group_pixels_argmin_plain(voted, centers,
                                                           valid),
                None, byts, n * p * kk * 6, "float32")
    if name == "segment_hist_and_sums":
        inst, sem, w, vec = args[:4]
        s = kwargs["num_segments"]
        c = kwargs["num_classes"]
        n, p = inst.shape
        d = vec.shape[-1]
        byts = _nbytes(inst, sem, w, vec) + n * s * (c + d) * 4
        # yardstick: one index_add_ into a flat (N*S*(C+D)) table, the
        # weight at column sem and vector component j at column C+j of row
        # n*S+inst; the flat indices are built here, outside the timing
        rows = ((torch.arange(n, device=inst.device)[:, None] * s
                 + inst.long()) * (c + d)).reshape(-1)
        flat = torch.cat([rows + sem.long().reshape(-1)]
                         + [rows + c + j for j in range(d)])
        vals = torch.cat([w.reshape(-1)] + [vec[..., j].reshape(-1)
                                            for j in range(d)])
        table = torch.zeros(n * s * (c + d), device=inst.device)
        return (lambda: seg.segment_hist_and_sums(inst, sem, w, vec, s, c),
                lambda: seg.segment_hist_and_sums_plain(inst, sem, w, vec, s,
                                                        c),
                lambda: table.index_add_(0, flat, vals),
                byts, n * p * (1 + d), "float32")
    if name == "segment_lookup":
        inst, tables = args
        n, p = inst.shape
        d = tables.shape[1]
        index = inst.long()[:, None, :].expand(n, d, p).contiguous()
        byts = _nbytes(inst, tables) + n * d * p * 4
        return (lambda: seg.segment_lookup(inst, tables),
                lambda: seg.segment_lookup_plain(inst, tables),
                lambda: torch.gather(tables, 2, index), byts, 0, "float32")
    if name == "semantic_decode":
        x, weight, interleaved = args
        n, h2, w2, c = x.shape
        byts = _nbytes(x, weight) + n * 4 * h2 * w2 * 8  # idx + score
        # per output pixel and class: 4 taps (8), max + argmax (1),
        # subtract + exp + add (3)
        plain = (sdec.semantic_decode_interleaved_plain if interleaved
                 else sdec.semantic_decode_planes_plain)
        return (lambda: sdec.semantic_decode(x, weight, interleaved),
                lambda: plain(x, weight), None,
                byts, n * 4 * h2 * w2 * c * 12, "float32")
    if name == "instance_head":
        x, weight, enc, interleaved = args
        n, h2, w2, c = x.shape
        byts = _nbytes(x, weight) + n * c * 4 * h2 * w2 * 4
        plain = (ihead.instance_head_upsample_interleaved_plain if interleaved
                 else ihead.instance_head_upsample_plain)
        # per output element: 4 taps (8) and the encode (~4)
        return (lambda: ihead.instance_head(x, weight, enc, interleaved),
                lambda: plain(x, weight, enc), None,
                byts, n * c * 4 * h2 * w2 * 12, "float32")
    if name == "decoder_trunk":
        con_out, skips, per_module = args
        n, h, w, _ = con_out.shape
        d = per_module[0]["cin_w"].shape[0]
        ops = 0
        for skip, m in zip(skips, per_module):
            ci, co = m["cin_w"].shape[-2:]
            k = m["blk_w31"].shape[1]
            # conv_in (9 taps), 4K three-tap convs, the 1x1 projection at
            # 2h x 2w; 2 operations per multiply-add
            ops += 2 * d * n * h * w * (9 * ci * co + 12 * k * co * co
                                        + 4 * skip.shape[-1] * co)
            h, w = 2 * h, 2 * w
        byts = (_nbytes(con_out, *skips, *(t for m in per_module
                                           for t in m.values()))
                + d * n * h * w * co * con_out.element_size())
        return (lambda: trunk.decoder_trunk(con_out, skips, per_module),
                lambda: trunk.decoder_trunk_plain(con_out, skips, per_module),
                None, byts, ops, str(con_out.dtype).split(".")[1])
    if name == "interleave_planes":
        (named,) = args
        words = _words(named)
        return (lambda: pint.interleave_planes(named),
                lambda: pint.interleave_planes_plain(named),
                lambda: [F.pixel_shuffle(x, 2) for x in words],
                2 * _nbytes(*words), 0, "float32")
    raise KeyError(name)


def rel_err(a, b):
    a = a.float()
    b = b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _semantic_decode_error(got, want, args, dtype_label):
    """Checks the semantic decode tolerance; returns (worst relative
    score error where the index agrees, share of pixels whose index
    differs, largest absolute score difference where it agrees)."""
    from emsanet_tpu_torch.ops.semantic_decode import bf16_near_ties

    (gi, gs), (wi, ws) = got, want
    same = gi == wi
    differ = float((~same).float().mean())
    d = (gs - ws).abs()
    abs_err = float(d[same].max()) if bool(same.any()) else 0.0
    rel = float((d / ws.abs().clamp_min(1e-30))[same].max()) if bool(
        same.any()) else 0.0
    name = f"semantic_decode ({dtype_label})"
    if dtype_label == "f32":
        if differ > 0:
            raise AssertionError(f"{name}: index differs on {differ:.2e} of "
                                 "the pixels")
        if rel > 1e-5:
            raise AssertionError(f"{name}: score error {rel:.2e} > 1e-5")
    else:
        if differ > 1e-4:
            raise AssertionError(f"{name}: index differs on {differ:.2e} of "
                                 "the pixels (> 1e-4)")
        x, weight, interleaved = args
        if bool((~same & ~bf16_near_ties(x, weight, interleaved)).any()):
            raise AssertionError(f"{name}: index differs where the top two "
                                 "values are more than one bf16 ulp apart")
        if abs_err > 1e-2:
            raise AssertionError(f"{name}: score error {abs_err:.2e} > 1e-2")
    return rel, differ, abs_err


def compare(name, args, kwargs, ops_mod, dtype_label):
    """Kernel vs plain on one call's inputs: (error, largest absolute
    difference); raises on disagreement."""
    import torch

    kfn, pfn, *_ = kernel_spec(name, args, kwargs, ops_mod)
    got, want = kfn(), pfn()
    torch.cuda.synchronize()
    if name == "semantic_decode":
        rel, differ, abs_err = _semantic_decode_error(got, want, args,
                                                      dtype_label)
        return max(rel, differ), abs_err
    if name == "interleave_planes":
        for key in want:
            g, w = got[key], want[key]
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                raise AssertionError(f"interleave_planes: map {key} differs")
        return 0.0, 0.0
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [
        (got, want)]
    abs_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in pairs)
    if name == "fused_stems":
        tol = 2e-2 if dtype_label == "bf16" else 1e-4
        err = max(rel_err(g, w) for g, w in zip(got, want))
    elif name == "nbt1d_chain":
        tol = 5e-2 if dtype_label == "bf16" else 1e-4
        err = rel_err(got, want)
    elif name == "instance_head":
        tol = 2e-2 if dtype_label == "bf16" else 1e-5
        err = rel_err(got, want)
    elif name == "decoder_trunk":
        tol = 5e-2 if dtype_label == "bf16" else 1e-4
        err = rel_err(got, want)
    elif name == "group_pixels_argmin":
        tol = 0.0
        err = 0.0 if (torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1])) else 1.0
    elif name == "segment_hist_and_sums":
        tol = 1e-4
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{name}: histogram differs")
        err = rel_err(got[1], want[1])
    else:
        tol = 0.0
        err = 0.0 if torch.equal(got, want) else 1.0
    if not err <= tol:
        raise AssertionError(f"{name} ({dtype_label}): error {err:.3e} > "
                             f"tolerance {tol:.1e}")
    return err, abs_err


def to_f32(name, args):
    """The same call's inputs with the activations in f32."""
    if name == "fused_stems":
        xs, ws, bns = args
        return ([x.float() for x in xs], ws, bns)
    if name == "nbt1d_chain":
        x, st = args
        return (x.float(), {k: v.float() for k, v in st.items()})
    if name in ("semantic_decode", "instance_head"):
        return (args[0].float(), args[1].float(), *args[2:])
    if name == "decoder_trunk":
        con_out, skips, per_module = args
        return (con_out.float(), [s.float() for s in skips],
                [{k: v.float() for k, v in m.items()} for m in per_module])
    return args


def _call_args(name, args, kwargs):
    """A captured call's (args, kwargs), with the variant flag of the
    semantic decode and instance head wrappers (`interleaved`) made the
    last positional argument."""
    if name not in ("semantic_decode", "instance_head"):
        return args, kwargs
    n_fixed = 2 if name == "semantic_decode" else 3
    flag = kwargs.get("interleaved",
                      args[n_fixed] if len(args) > n_fixed else False)
    return (*args[:n_fixed], flag), {}


# ---------------------------------------------------------------------------


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from emsanet_tpu_torch.bench import (
            build_flagship,
            make_frame,
            random_raw_inputs,
            time_cuda,
        )
        from emsanet_tpu_torch.ops import (
            _native,
            decoder_trunk,
            grouping,
            instance_head,
            nbt1d_chain,
            plane_interleave,
            segment_kernels,
            semantic_decode,
            stem,
        )
    except ImportError as e:
        print(f"chip_smoke: the emsanet_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)  # parameters reach the plain versions
    modules = {"stem": stem, "nbt1d_chain": nbt1d_chain,
               "grouping": grouping, "segment_kernels": segment_kernels,
               "semantic_decode": semantic_decode,
               "instance_head": instance_head,
               "plane_interleave": plane_interleave,
               "decoder_trunk": decoder_trunk}
    ops_mod = (stem, nbt1d_chain, grouping, segment_kernels, semantic_decode,
               instance_head, plane_interleave, decoder_trunk)
    os.makedirs(OUT_DIR, exist_ok=True)
    open(LOG_FILE, "w").close()
    card = gpu_name_and_limit()
    t_start = time.time()

    # -- 1. build ----------------------------------------------------------
    t0 = time.time()
    logs = _native.build_all()
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for src, text in logs.items():
            f.write(f"== {src}\n{text}\n")
    log(f"[build] {len(_native.SOURCES)} kernel sources in "
        f"{time.time() - t0:.1f} s")
    for src, kernel in STACK_FREE:
        if not logs[src]:  # empty: built by an earlier run
            continue
        props = ptxas_props(logs[src], kernel)
        log(f"[build] ptxas {kernel} (each instantiation): "
            + "; ".join(f"{p['name']}: {p['stack']} bytes stack, "
                        f"{p['registers']} registers, {p['smem']} bytes "
                        "static smem" for p in props))
        if len(props) != 2 or any(p["stack"] for p in props):
            raise AssertionError(f"{kernel}: stack frames "
                                 f"{[p['stack'] for p in props]}, expected "
                                 "0 bytes for both instantiations")
    for src, kernel, inst in TENSOR_CORE_SASS:
        n_mma = sass_mma_count(_native._target(src), kernel, inst)
        log(f"[build] SASS of {kernel}<{inst}>: {n_mma} tensor-core "
            f"instructions ({'/'.join(TENSOR_CORE_OPS)})")
        if n_mma <= 0:
            raise AssertionError(f"{kernel}<{inst}> has no tensor-core "
                                 "instruction in its SASS")

    # -- 2. main path, 3. kernels vs plain: mode by mode --------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = {b: random_raw_inputs(b, 480, 640, seed=b, device="cuda")
              for b in BATCHES}
    frames, results, launches = {}, {}, {}
    total = {name: 0 for name, *_ in KERNELS}
    errors = {}
    max_abs = {name: 0.0 for name, *_ in KERNELS}  # b8 bf16, timing mode
    captured = {}  # (mode, name, b) -> calls, kept for the timing phase
    for mode in MODES:
        model, cfg, ds = build_flagship(480, 640, "bfloat16", "resnet34",
                                        "cuda", seed=0,
                                        head_decode_fusion=mode)
        frame = make_frame(model, cfg, ds)
        frames[mode] = frame
        for b in BATCHES:  # warm-up: lazy init, cuDNN heuristics
            frame(inputs[b])
        torch.cuda.synchronize()

        reset_counts(modules)
        calls = {}
        results[mode] = {}
        for b in BATCHES:
            with Capture(modules) as cap:
                results[mode][b] = frame(inputs[b])
            calls[b] = cap.calls
        torch.cuda.synchronize()
        launches[mode] = counts(modules)
        log(f"[main path {mode}] launches over the b1 + b8 frames: "
            f"{json.dumps(launches[mode])}")
        for name in PATH_KERNELS[mode]:
            if launches[mode][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"main path of mode {mode}")
        for name, n in launches[mode].items():
            total[name] += n

        for name, *_ in KERNELS:
            for b in BATCHES:
                mode_calls = [_call_args(name, a, k)
                              for a, k in calls[b][name]]
                for args, kwargs in mode_calls:
                    for label, a in (("bf16", args),
                                     ("f32", to_f32(name, args))):
                        err, abs_err = compare(name, a, kwargs, ops_mod,
                                               label)
                        key = f"{name}/{label}"
                        errors[key] = max(errors.get(key, 0.0), err)
                        if (b == ENTRY_BATCH.get(name, 8)
                                and label == "bf16"
                                and mode == TIMING_MODE):
                            max_abs[name] = max(max_abs[name], abs_err)
                if mode == TIMING_MODE or name in NEW_KERNELS:
                    captured[mode, name, b] = mode_calls
        del calls
        check_outputs(results[mode], mode)
    log(f"[kernels vs plain] worst errors: {json.dumps(errors)}")
    for name in REPEAT_KERNELS:
        for args, kwargs in captured[TIMING_MODE, name, 8]:
            kfn = kernel_spec(name, args, kwargs, ops_mod)[0]
            first, again = kfn(), kfn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{name}: two calls on the {TIMING_MODE}"
                                     " b8 frame's inputs differ")
        log(f"[kernel repeats] {name}: two calls on each of the "
            f"{TIMING_MODE} b8 frame's inputs are bit-identical")

    r8 = results[TIMING_MODE][8]
    log(f"[outputs] {TIMING_MODE} b8: valid centers per image "
        f"{r8['instance_centers_valid'].sum(1).tolist()}, instance pixel "
        f"share {float((r8['instance_segmentation'] > 0).float().mean()):.3f}"
        f", classes seen {int(r8['semantic_segmentation_idx'].unique().numel())}")
    agreement = {}
    for mode, other in [(m, "interleave") for m in MODES[1:]] + [
            ("decode-planes", "decode-both")]:
        agreement[f"{mode} vs {other}"] = _agreement(results[mode][8],
                                                     results[other][8])
    log(f"[outputs] b8 share of pixels (and of center slots) that agree "
        f"(logged, not gated): {json.dumps(agreement)}")

    # -- 4. small frames: card (kernels, f32) vs CPU (plain versions) ------
    small = small_frames(torch, build_flagship, make_frame, random_raw_inputs)

    # -- 5. timing ---------------------------------------------------------
    # rounds over the modes in turn, so that a slow spell of the shared
    # host does not fall on one mode only; the median round is reported
    rounds = {(mode, b): [] for mode in MODES for b in BATCHES}
    for _ in range(FRAME_ROUNDS):
        for mode in MODES:
            for b in BATCHES:
                rounds[mode, b].append(time_cuda(
                    lambda: frames[mode](inputs[b]), 2, 10))
    frame_ms = {mode: {b: statistics.median(rounds[mode, b])
                       for b in BATCHES} for mode in MODES}
    for mode in MODES:
        log(f"[frame {mode}] ms per batch, median of {FRAME_ROUNDS} rounds "
            f"of 10: b1 {frame_ms[mode][1]:.3f} "
            f"({min(rounds[mode, 1]):.3f}-{max(rounds[mode, 1]):.3f}), b8 "
            f"{frame_ms[mode][8]:.3f} ({min(rounds[mode, 8]):.3f}-"
            f"{max(rounds[mode, 8]):.3f}; {frame_ms[mode][8] / 8:.3f} per "
            "frame)")

    entries = []
    detail = {}
    for name, _, source, replaces in KERNELS:
        per_b = {}
        for mode in MODES:
            for b in BATCHES:
                calls = captured.get((mode, name, b))
                if not calls:
                    continue
                variants = {}
                for args, kwargs in calls:
                    kfn, pfn, lfn, byts, ops, odt = kernel_spec(
                        name, args, kwargs, ops_mod)
                    key = _variant(name, args)
                    tot = variants.setdefault(key, {
                        "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": None, "bound_by": None, "calls": 0,
                        "sites": []})
                    ms = time_cuda(kfn, 2, 10)
                    plain = time_cuda(pfn, 2, 10)
                    t_bytes = byts / PEAK_BYTES * 1e3
                    t_ops = ops / PEAK_OPS[odt] * 1e3
                    bound = max(t_bytes, t_ops)
                    tot["ms"] += ms
                    tot["plain_ms"] += plain
                    tot["bound_ms"] += bound
                    tot["calls"] += 1
                    by = "bytes" if t_bytes >= t_ops else "operations"
                    tot["bound_by"] = by if tot["bound_by"] in (None, by) \
                        else "operations"
                    if lfn is not None:
                        lib = time_cuda(lfn, 2, 10)
                        tot["library_ms"] = (tot["library_ms"] or 0.0) + lib
                    if name == "nbt1d_chain":
                        x = args[0]
                        tot["sites"].append({
                            "shape": list(x.shape),
                            "K": int(args[1]["w31"].shape[0]), "ms": ms,
                            "plain_ms": plain, "bound_ms": bound})
                for key, tot in variants.items():
                    per_b[f"{mode}/b{b}/{key}"] = tot
        detail[name] = per_b
        eb = ENTRY_BATCH.get(name, 8)
        at = _timed_at(per_b, eb)
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total[name],
            "max_abs_err": max_abs[name], "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "batch": eb,
            # both batches; the device times are filled in by phase 6
            **{f"ms_b{b}": (_timed_at(per_b, b) or {}).get("ms")
               for b in BATCHES},
        })
    for name, per_b in detail.items():
        for key, t in per_b.items():
            if "/b8/" in key and not key.startswith(TIMING_MODE):
                log(f"[kernel {key}] {name}: ms {t['ms']:.4f} plain "
                    f"{t['plain_ms']:.4f} bound {t['bound_ms']:.4f}")
            if key.startswith(f"{TIMING_MODE}/b1/"):
                log(f"[kernel b1] {name}: ms {t['ms']:.4f} plain "
                    f"{t['plain_ms']:.4f} bound {t['bound_ms']:.4f} calls "
                    f"{t['calls']}")

    # -- 5b. the trunk on vs off (logged, not gated), timed before any
    # profiler has run in the process -------------------------------------
    trunk_report = trunk_on_off(torch, frames[TIMING_MODE], ops_mod, card)
    for e in entries:  # the 'auto' frames run the trunk at b1 only
        if e["name"] == "decoder_trunk":
            e["ms_b8"] = trunk_report["kernel_b8"]["ms"]
            e["device_ms_b8"] = trunk_report["kernel_b8"]["device_ms"]

    # -- 6. profile ----------------------------------------------------------
    busy = {}
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"{card}\n")
        for mode in MODES:
            for b in BATCHES:
                for attempt in range(1, PROFILE_ATTEMPTS + 1):
                    wall_ms, rows = profile_frame(frames[mode], inputs[b])
                    busy_ms = sum(r[0] for r in rows)
                    missing = missing_in_trace(rows, b, f"{mode} b{b}") \
                        if busy_ms > 0 else []
                    if not missing:
                        break
                    log(f"[profile {mode} b{b}] the trace lacks {missing} "
                        f"(attempt {attempt} of {PROFILE_ATTEMPTS})")
                if missing:
                    raise AssertionError(f"profiled frame {mode} b{b}: "
                                         f"{missing} did not run")
                depthwise = sum(r[0] for r in rows
                                if "conv_depthwise2d" in r[2])
                busy[f"{mode}/b{b}"] = {"wall_ms": wall_ms,
                                        "busy_ms": busy_ms,
                                        "depthwise_ms": depthwise,
                                        "frame_ms": frame_ms[mode][b],
                                        "attempts": attempt}
                f.write(f"{mode} b{b} frame under torch.profiler: wall "
                        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
                        f"ATen conv_depthwise2d {depthwise:.3f} ms\n")
                for ms, count, key in rows:
                    f.write(f"{ms:10.4f} ms {count:6d}x  {key}\n")
                top = ", ".join(f"{key[:40]} {ms:.3f}"
                                for ms, _, key in rows[:5])
                log(f"[profile {mode} b{b}] wall {wall_ms:.3f} ms, device "
                    f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% "
                    f"of the profiled frame, "
                    f"{100 * busy_ms / frame_ms[mode][b]:.1f}% of the timed "
                    f"one), conv_depthwise2d {depthwise:.3f} ms; top kernels "
                    f"(ms): {top}" if busy_ms > 0 else
                    f"[profile {mode} b{b}] no device time recorded: not "
                    "measured")
    # the kernels that have a library yardstick, on device time (a
    # wrapper's time includes its host work): kernel against library
    # call on the first captured call of the decode-planes b8 frame
    library_device = {}
    for name, *_ in KERNELS:
        calls = captured.get((TIMING_MODE, name, 8))
        if not calls:
            continue
        kfn, _, lfn, *_ = kernel_spec(name, *calls[0], ops_mod)
        if lfn is None:
            continue
        library_device[name] = {"device_ms": device_ms(kfn),
                                "library_device_ms": device_ms(lfn)}
        log(f"[device time] {name}: kernel "
            f"{library_device[name]['device_ms']:.4f} ms, library "
            f"{library_device[name]['library_device_ms']:.4f} ms")
    # every kernel's device time at b1 and b8: the calls its "ms_bN" sums
    for e in entries:
        for b in BATCHES:
            if e.get(f"device_ms_b{b}") is not None:
                continue
            calls = [(a, k) for a, k in captured.get(
                (TIMING_MODE, e["name"], b), [])
                if _variant(e["name"], a) == _timed_key(detail[e["name"]], b)]
            e[f"device_ms_b{b}"] = sum(
                device_ms(kernel_spec(e["name"], a, k, ops_mod)[0])
                for a, k in calls) if calls else None
        log(f"[kernel b1/b8] {e['name']}: " + "; ".join(
            f"b{b} ms {_ms(e[f'ms_b{b}'])} device {_ms(e[f'device_ms_b{b}'])}"
            for b in BATCHES))
    chain_report = chain_sites(torch, captured, ops_mod, card)
    # -- 7. train -------------------------------------------------------------
    del frames, captured, results
    torch.cuda.empty_cache()
    train_entries, train_report = train_phase(torch, card)
    entries.extend(train_entries)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": card, "frame_ms": frame_ms, "detail": detail,
                   "launches": launches, "errors": errors,
                   "agreement_b8": agreement,
                   "small_frames": small, "profile": busy,
                   "trunk_on_off": trunk_report,
                   "library_device": library_device,
                   "chain_sites": chain_report,
                   "train": train_report}, f, indent=1)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _ms(v):
    return "-" if v is None else f"{v:.4f}"


def _timed_key(per_b, b):
    """The variant whose calls give a kernel's times at batch b: the first
    one of the timing mode's (planes for the semantic decode and the
    instance head), or None where the batch does not run the kernel."""
    keys = [k for k in per_b if k.startswith(f"{TIMING_MODE}/b{b}/")]
    return keys[0].rsplit("/", 1)[1] if keys else None


def _timed_at(per_b, b):
    key = _timed_key(per_b, b)
    return per_b[f"{TIMING_MODE}/b{b}/{key}"] if key else None


def sass_mma_count(lib_path, kernel, inst):
    """Tensor-core instructions (TENSOR_CORE_OPS) in the SASS of the
    instantiation of `kernel` for `inst` in a built library
    (`cuobjdump -sass`)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line and inst in line
        elif inside:
            count += sum(line.count(op) for op in TENSOR_CORE_OPS)
    return count


def _variant(name, args):
    if name in ("semantic_decode", "instance_head"):
        return "interleaved" if args[-1] else "planes"
    return "all"


def _agreement(a, b):
    """Share of equal pixels per map, of center slots with the same
    validity and position, and of distinct scores among the valid
    centers (tied center scores make the top-k order, and so the instance
    ids, differ between modes)."""
    share = {key: float((a[key] == b[key]).float().mean())
             for key in ("semantic_segmentation_idx", "instance_segmentation",
                         "panoptic_segmentation_deeplab")}
    same = (a["instance_centers_valid"] == b["instance_centers_valid"]) & (
        (a["instance_centers_yx"] == b["instance_centers_yx"]).all(-1)
        | ~a["instance_centers_valid"])
    share["center_slots"] = float(same.float().mean())
    for tag, res in (("a", a), ("b", b)):
        scores = res["instance_centers_score"][res["instance_centers_valid"]]
        share[f"distinct_center_scores_{tag}"] = (
            int(scores.unique().numel()), int(scores.numel()))
    return share


def check_outputs(res_by_batch, mode):
    """Finite values of the expected shapes in one mode's frames."""
    import torch

    for b, res in res_by_batch.items():
        for key, v in res.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{mode} b{b}: non-finite values in "
                                     f"{key}")
        for key, shape in (("semantic_segmentation_idx", (b, 480, 640)),
                           ("semantic_segmentation_score", (b, 480, 640)),
                           ("instance_segmentation", (b, 480, 640)),
                           ("panoptic_segmentation_deeplab", (b, 480, 640)),
                           ("instance_centers_yx", (b, 64, 2)),
                           ("scene_class_idx", (b,))):
            if tuple(res[key].shape) != shape:
                raise AssertionError(f"{mode} b{b}: {key} has shape "
                                     f"{tuple(res[key].shape)}, not {shape}")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def small_frames(torch, build_flagship, make_frame, random_raw_inputs):
    """Small f32 b2 frames on the card against the same frames on the CPU.
    With 'auto' the card's frames take the decoder trunk kernel and the
    CPU's the unfused decoders; with 'on' both take the trunk (the CPU
    through its plain version)."""
    from emsanet_tpu_torch.ops import decoder_trunk

    report = {}
    for (h, w), mode, megakernel in (((96, 128), "interleave", "auto"),
                                     ((128, 160), "decode-planes", "auto"),
                                     ((128, 160), "decode-both", "auto"),
                                     ((96, 128), "interleave", "on")):
        cuda, scfg, sds = build_flagship(h, w, "float32", "resnet18", "cuda",
                                         seed=1, head_decode_fusion=mode,
                                         decoder_megakernel=megakernel)
        cpu, _, _ = build_flagship(h, w, "float32", "resnet18", "cpu",
                                   seed=1, head_decode_fusion=mode,
                                   decoder_megakernel=megakernel)
        sin = random_raw_inputs(2, h, w, seed=3, device="cpu")
        sin_cuda = {k: v.cuda() for k, v in sin.items()}
        before = decoder_trunk.decoder_trunk.launches
        raw_cuda = dict(_leaves(make_frame(cuda, scfg, sds, False)(sin_cuda)))
        if decoder_trunk.decoder_trunk.launches != before + 1:
            raise AssertionError(f"small frame {h}x{w} {mode} "
                                 f"{megakernel}: the trunk kernel did not "
                                 "launch once")
        tag = f"{h}x{w} {mode}" + (" 'on'" if megakernel == "on" else "")
        raw_cpu = dict(_leaves(make_frame(cpu, scfg, sds, False)(sin)))
        worst = max(rel_err(raw_cuda[k].cpu(), v) for k, v in raw_cpu.items())
        if worst > 1e-3:
            raise AssertionError(f"small frame {tag}: card vs CPU raw error "
                                 f"{worst:.3e}")
        post_cuda = make_frame(cuda, scfg, sds)(sin_cuda)
        post_cpu = make_frame(cpu, scfg, sds)(sin)
        if sorted(post_cuda) != sorted(post_cpu):
            raise AssertionError(f"small frame {tag}: keys differ")
        agree = {}
        for key in ("semantic_segmentation_idx", "instance_segmentation",
                    "panoptic_segmentation_deeplab"):
            agree[key] = float((post_cuda[key].cpu() == post_cpu[key])
                               .float().mean())
            if agree[key] < 0.99:
                raise AssertionError(f"small frame {tag}: {key} agrees on "
                                     f"only {agree[key]:.4f} of the pixels")
        report[tag] = {"raw_rel_err": worst, "agree": agree}
        log(f"[outputs] small frame {tag}, card vs CPU: raw outputs max "
            f"rel err {worst:.2e}; postprocessed maps agree on "
            f"{json.dumps(agree)}")
    return report


def trunk_on_off(torch, frame_auto, ops_mod, card):
    """The decode-planes frame with the decoder trunk kernel ('auto' at b1
    and b2, 'on' at b8) against 'off', at b1, b2 and b8: frame ms (median
    of rounds, the two in alternating order), device busy ms and device
    kernels per frame under torch.profiler, and the trunk kernel's own
    time beside its plain version and bound at b2 and b8. Logged, not
    gated: the H100's answer to the reference's MAX_BATCH gate."""
    from emsanet_tpu_torch.bench import (
        build_flagship,
        make_frame,
        random_raw_inputs,
        time_cuda,
    )
    from emsanet_tpu_torch.ops import decoder_trunk as trunk

    frames = {"auto": frame_auto}
    for mk in ("on", "off"):
        model, cfg, ds = build_flagship(480, 640, "bfloat16", "resnet34",
                                        "cuda", seed=0,
                                        head_decode_fusion=TIMING_MODE,
                                        decoder_megakernel=mk)
        frames[mk] = make_frame(model, cfg, ds)
    with_trunk = {1: "auto", 2: "auto", 8: "on"}
    inputs = {b: random_raw_inputs(b, 480, 640, seed=b, device="cuda")
              for b in TRUNK_BATCHES}
    for b in TRUNK_BATCHES:
        for variant, want in ((with_trunk[b], 1), ("off", 0)):
            before = trunk.decoder_trunk.launches
            frames[variant](inputs[b])
            got = trunk.decoder_trunk.launches - before
            if got != want:
                raise AssertionError(f"trunk on/off b{b} {variant}: {got} "
                                     f"trunk launches, expected {want}")
    torch.cuda.synchronize()
    rounds = {(b, v): [] for b in TRUNK_BATCHES for v in ("trunk", "off")}
    for r in range(FRAME_ROUNDS):
        for b in TRUNK_BATCHES:
            for v in (("trunk", "off") if r % 2 == 0 else ("off", "trunk")):
                f = frames[with_trunk[b] if v == "trunk" else "off"]
                rounds[b, v].append(time_cuda(lambda: f(inputs[b]), 2, 10))
    report = {"card": card}
    for b in TRUNK_BATCHES:
        line = []
        for v in ("trunk", "off"):
            f = frames[with_trunk[b] if v == "trunk" else "off"]
            wall_ms, rows = profile_frame(f, inputs[b])
            entry = {
                "frame_ms": statistics.median(rounds[b, v]),
                "rounds": rounds[b, v],
                "busy_ms": sum(r[0] for r in rows),
                "device_kernels": sum(r[1] for r in rows),
                "trunk_kernel_dev_ms": sum(
                    r[0] for r in rows if "decoder_trunk_kernel" in r[2]),
                "profiled_wall_ms": wall_ms,
            }
            report[f"b{b}/{v}"] = entry
            line.append(f"{v} {entry['frame_ms']:.3f} ms "
                        f"({min(entry['rounds']):.3f}-"
                        f"{max(entry['rounds']):.3f}), busy "
                        f"{entry['busy_ms']:.3f} ms, "
                        f"{entry['device_kernels']} device kernels")
        log(f"[trunk on/off {TIMING_MODE} b{b}] " + "; ".join(line))
    spec = [k for k in KERNELS if k[0] == "decoder_trunk"]
    captured = {}
    for b in (1, 2, 8):
        with Capture({"decoder_trunk": trunk}, spec) as cap:
            frames[with_trunk[b]](inputs[b])
        ((args, kwargs),) = cap.calls["decoder_trunk"]
        captured[b] = args
        if b < 8:  # split partials added in split order: the same bits
            first, again = (trunk.decoder_trunk(*args) for _ in range(2))
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                raise AssertionError(f"decoder_trunk b{b}: two calls "
                                     "differ")
            log(f"[trunk kernel b{b}] two calls on the frame's inputs: "
                "bit-identical")
        if b == 1:  # its other numbers are phase 5's
            report["kernel_b1_device_ms"] = device_ms(
                lambda: trunk.decoder_trunk(*args))
            log(f"[trunk kernel b1] device "
                f"{report['kernel_b1_device_ms']:.4f} ms")
            continue
        kfn, pfn, _, byts, ops, odt = kernel_spec("decoder_trunk", args,
                                                  kwargs, ops_mod)
        t = {"ms": time_cuda(kfn, 2, 10), "plain_ms": time_cuda(pfn, 2, 10),
             "bound_ms": max(byts / PEAK_BYTES, ops / PEAK_OPS[odt]) * 1e3,
             "device_ms": device_ms(kfn)}
        report[f"kernel_b{b}"] = t
        log(f"[trunk kernel b{b}] ms {t['ms']:.4f} device "
            f"{t['device_ms']:.4f} plain {t['plain_ms']:.4f} bound "
            f"{t['bound_ms']:.4f}")
    # the same weights on a 2x2 context at b1: the phases' work is a few
    # tiles, so this is the kernel's fixed cost (its 41 grid barriers and
    # one read of the weights)
    con_out, skips, per_module = captured[1]
    g = torch.Generator(device="cuda").manual_seed(0)
    tiny = [torch.randn((1, 2 << i, 2 << i, s.shape[-1]), generator=g,
                        device="cuda").to(s.dtype) for i, s in enumerate(
                            [con_out] + list(skips))]
    tiny_fn = lambda: trunk.decoder_trunk(tiny[0], tiny[1:], per_module)  # noqa: E731
    ms, dev = time_cuda(tiny_fn, 2, 10), device_ms(tiny_fn)
    report["kernel_b1_2x2_context"] = ms
    report["kernel_b1_2x2_context_device_ms"] = dev
    log(f"[trunk kernel] fixed cost (2x2 context, b1, flagship weights): "
        f"ms {ms:.4f}, device {dev:.4f}")
    report["phases"] = {
        "b1": trunk_phases(torch, trunk, captured[1], "b1"),
        "2x2": trunk_phases(torch, trunk, (tiny[0], tiny[1:], per_module),
                            "2x2 context")}
    return report


def trunk_phases(torch, trunk, args, tag, runs=5):
    """The bf16 trunk kernel's phases from %globaltimer stamps (median of
    `runs` stamped launches, after one warm-up), in microseconds: per
    phase its work (start to the last block's end of its units) and its
    wait (to the next phase's start, across the grid barrier), and block
    0's first unit step by step (`UNIT_STEPS`). Logged."""
    import math

    trunk.decoder_trunk_phase_ns(*args)
    runs_ns = [trunk.decoder_trunk_phase_ns(*args)[1] for _ in range(runs)]
    rows = []
    for i, first in enumerate(runs_ns[0]):
        unit = []
        for k in range(len(trunk.UNIT_STEPS)):
            vals = [r[i]["unit"][k] for r in runs_ns
                    if r[i]["unit"][k] is not None]
            unit.append(statistics.median(vals) / 1e3 if vals else None)
        rows.append({
            "phase": first["phase"],
            "work_us": statistics.median(r[i]["work"] for r in runs_ns) / 1e3,
            "wait_us": statistics.median(r[i]["wait"] for r in runs_ns) / 1e3,
            "unit_us": unit})
    work = sum(r["work_us"] for r in rows)
    wait = sum(r["wait_us"] for r in rows)
    log(f"[trunk phases {tag}] {len(rows)} phases, median of {runs} "
        f"stamped launches: work {work:.1f} us, wait at the barriers "
        f"{wait:.1f} us; per phase work/wait us and block 0's first unit "
        f"({', '.join(trunk.UNIT_STEPS)}; us from the phase's start): "
        + "; ".join(
            f"{r['phase']} {r['work_us']:.1f}/{r['wait_us']:.1f} ["
            + " ".join("-" if v is None or math.isnan(v) else f"{v:.1f}"
                       for v in r["unit_us"]) + "]" for r in rows))
    return rows


def ptxas_props(build_log, kernel):
    """`ptxas -v`'s stack frame, registers and static shared memory of
    each instantiation of kernel (the f32 and the bf16 one)."""
    import re

    out, lines = [], build_log.splitlines()
    for i, line in enumerate(lines[:-2]):
        if "Function properties for" in line and kernel in line:
            used = lines[i + 2]
            regs = re.search(r"Used (\d+) registers", used)
            smem = re.search(r"(\d+) bytes smem", used)
            out.append({
                "name": "bf16" if "bfloat16" in line else "f32",
                "stack": int(lines[i + 1].split("bytes stack frame")[0]),
                "registers": int(regs.group(1)) if regs else None,
                "smem": int(smem.group(1)) if smem else 0})
    return out


def missing_in_trace(rows, b, where):
    """The kernels a profiled bf16 frame must run that its trace lacks:
    the chain's wgmma kernels, and at b1 the bf16 trunk kernel. Raises if
    the first design's mma.sync chain conv ran."""
    names = [r[2] for r in rows]
    if any(OLD_CHAIN_KERNEL in n for n in names):
        raise AssertionError(f"profiled frame {where}: {OLD_CHAIN_KERNEL} "
                             "ran")
    need = CHAIN_DEVICE_KERNELS + ((TRUNK_DEVICE_KERNEL,) if b == 1 else ())
    return [k for k in need if not any(k in n for n in names)]


def cudnn_chain(torch, x, st):
    """cuDNN's convs of the chain alone (F.conv2d 3x1 then 1x3 per pair,
    channels_last, in x's dtype), without the pairs' bias, BatchNorm,
    residual and ReLU: a yardstick for the chain's convs, never the
    port's path."""
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)  # NHWC memory: channels_last
    k = st["w31"].shape[0]
    ws = [(st["w31"][b, i].permute(2, 1, 0)[..., None].to(x.dtype)
           .contiguous(memory_format=torch.channels_last),
           st["w13"][b, i].permute(2, 1, 0)[:, :, None].to(x.dtype)
           .contiguous(memory_format=torch.channels_last))
          for b in range(k) for i in range(2)]

    def run():
        y = xc
        for w31, w13 in ws:
            y = F.conv2d(F.conv2d(y, w31, padding=(1, 0)), w13,
                         padding=(0, 1))
        return y

    return run


def chain_sites(torch, captured, ops_mod, card):
    """Per chain site of the decode-planes b1 and b8 frames (logged): C,
    HxW, batch, blocks, pair launches, wrapper and device ms, bound and
    what sets it, TFLOP/s of the device time, and cuDNN's convs alone as
    a yardstick. Gated: the b1 calls repeat bit for bit."""
    from emsanet_tpu_torch.bench import time_cuda

    report = []
    for b in BATCHES:
        for args, kwargs in captured.get((TIMING_MODE, "nbt1d_chain", b), []):
            kfn, _, _, byts, ops, odt = kernel_spec("nbt1d_chain", args,
                                                   kwargs, ops_mod)
            x, st = args
            n, h, w, c = x.shape
            k = int(st["w31"].shape[0])
            if b == 1:
                first, again = kfn(), kfn()
                torch.cuda.synchronize()
                if not torch.equal(first, again):
                    raise AssertionError(f"nbt1d_chain b1 {h}x{w} C={c}: "
                                         "two calls differ")
            t_bytes, t_ops = byts / PEAK_BYTES * 1e3, ops / PEAK_OPS[odt] * 1e3
            dev = device_ms(kfn)
            site = {
                "c": c, "hw": f"{h}x{w}", "batch": n, "blocks": k,
                "launches": 2 * k, "ms": time_cuda(kfn, 2, 10),
                "device_ms": dev, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "tflops_device": ops / dev / 1e9 if dev > 0 else None,
                "cudnn_ms": time_cuda(cudnn_chain(torch, x, st), 2, 10),
            }
            report.append(site)
            log(f"[chain site] C={c} {h}x{w} b{n} K={k}: "
                f"{site['launches']} pair launches, ms {site['ms']:.4f}, "
                f"device {dev:.4f}, bound {site['bound_ms']:.4f} "
                f"({site['bound_by']}), "
                + (f"{site['tflops_device']:.1f} TFLOP/s device, "
                   if dev > 0 else "device time not measured, ")
                + f"cuDNN convs alone {site['cudnn_ms']:.4f} ms (yardstick)")
    for b in BATCHES:
        sites = [r for r in report if r["batch"] == b]
        log(f"[chain] b{b} frame: wrapper ms "
            f"{sum(r['ms'] for r in sites):.4f}, device ms "
            f"{sum(r['device_ms'] for r in sites):.4f}, bound "
            f"{sum(r['bound_ms'] for r in sites):.4f}, cuDNN convs alone "
            f"{sum(r['cudnn_ms'] for r in sites):.4f}; {card}")
    return report


def device_ms(fn, runs=10):
    """Device milliseconds per call of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3 / runs


def profile_frame(frame, batch):
    """(wall ms, [(device ms, count, kernel name)]) of one frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user annotations (the optimizer's step range) span kernels that
    # are counted on their own
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not ev.key.startswith("Optimizer.")]
    return wall_ms, sorted(rows, reverse=True)


# ---------------------------------------------------------------------------
# 7. training


def train_setup(torch, height, width, backbone, batch_size, dtype, device,
                dropout, seed=0):
    """(model, optimizer, step, device batch, cfg, loader seconds per
    batch) of a synthetic-data training configuration: the first of 3
    batches drawn through the train preprocessor and the loader."""
    from emsanet_tpu_torch import config as pc
    from emsanet_tpu_torch.data import DataLoader
    from emsanet_tpu_torch.datasets.metadata import get_dataset_config
    from emsanet_tpu_torch.datasets.synthetic import get_dataset
    from emsanet_tpu_torch.models.emsanet import build_train_model
    from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
    from emsanet_tpu_torch.training.optim import get_optimizer
    from emsanet_tpu_torch.training.step import (
        extract_device_batch,
        make_train_step,
    )

    drop = {} if dropout else {
        "dropout_p": 0.0, "semantic_decoder_block_dropout_p": 0.0,
        "instance_decoder_block_dropout_p": 0.0}
    cfg = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(
            tasks=("semantic", "instance", "orientation", "scene"),
            enable_panoptic=True, input_height=height, input_width=width,
            rgb_encoder_backbone=backbone, depth_encoder_backbone=backbone,
            fused_training=True, **drop),
        data=pc.DataConfig(dataset="synthetic", batch_size=batch_size,
                           synthetic_n_samples=3 * batch_size),
        train=pc.TrainConfig(mixed_precision=dtype == "bfloat16",
                             seed=seed)))
    ds_config = get_dataset_config("synthetic")
    dataset = get_dataset(cfg.data, cfg.model, "train")
    dataset.preprocessor = get_preprocessor(
        cfg, ds_config, "train",
        multiscale_downscales=cfg.model.side_output_downscales)
    loader = DataLoader(dataset, batch_size, shuffle=True, drop_last=True,
                        n_workers=8, seed=seed)
    t0 = time.perf_counter()
    batch = None
    for b in loader.batches(0):  # 3 batches: the workers' steady state
        batch = b if batch is None else batch
    loader_s = (time.perf_counter() - t0) / len(loader)
    cw = torch.from_numpy(dataset.semantic_compute_class_weights()).to(device)
    model = build_train_model(cfg.model, ds_config, device=device, seed=seed)
    opt = get_optimizer(model.parameters(), cfg.train)
    step = make_train_step(model, cfg, opt, cw)
    return (model, opt, step, extract_device_batch(batch, device), cfg,
            loader_s)


def _finite_losses(metrics, where):
    import torch

    for key, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{where}: loss {key} is not finite")


def train_kernel_spec(name, args, tm, hm):
    """(kernel fn, plain fn, bytes, ops, ops dtype) of one captured call
    of a train kernel; ops of the pair count 2 ops per multiply-add."""
    if name in ("pair_fwd", "pair_bwd"):
        u = args[1]
        n, h, w, c = u.shape
        px, it = n * h * w, u.element_size()
        wbytes = 2 * 3 * c * c * it
        if name == "pair_fwd":
            byts = 2 * px * c * it + wbytes
            ops = 12 * c * c * px
            return (lambda: tm.pair_fwd(*args),
                    lambda: tm.pair_fwd_plain(*args), byts, ops,
                    str(u.dtype).split(".")[1])
        # recompute the forward (12 C^2 per pixel), then data and weight
        # gradients of both convs (24 C^2)
        byts = 3 * px * c * it + wbytes + 2 * 3 * c * c * 4
        return (lambda: tm.pair_bwd(*args), lambda: tm.pair_bwd_plain(*args),
                byts, 36 * c * c * px, str(u.dtype).split(".")[1])
    x, target = args[0], args[2]
    logits = x.numel() * 4  # full-res logits
    byts = x.numel() * x.element_size() + target.numel() * 4
    if name == "head_loss_fwd":
        # per logit: 4 taps (7), max, exp of the difference and sum (~5)
        return (lambda: hm.head_loss_fwd(*args),
                lambda: hm.head_loss_fwd_plain(*args), byts, 12 * logits,
                "float32")
    # per logit: the forward's 12, softmax and dz (~4), dx and dweight
    # taps (16)
    return (lambda: hm.head_loss_bwd(*args),
            lambda: hm.head_loss_bwd_plain(*args),
            byts + x.numel() * x.element_size(), 32 * logits, "float32")


def _train_f32(name, args):
    if name.startswith("pair"):
        mode, u, s, t, w31, b31, w13, b13, *rest = args
        out = [mode, u.float(), s, t, w31.float(), b31, w13.float(), b13]
        if rest:
            out += [rest[0].float(), rest[1]]
        return tuple(out)
    return (args[0].float(), *args[1:])


def compare_train(name, args, tm, hm, label):
    """A train kernel against its plain version on one call's inputs:
    (gated error per output, largest absolute difference, error relative
    to the max per output); raises beyond the tolerance."""
    import torch

    kfn, pfn, *_ = train_kernel_spec(name, args, tm, hm)
    with torch.no_grad():
        got, want = kfn(), pfn()
    torch.cuda.synchronize()
    bf16 = label == "bf16"
    if name == "pair_fwd":
        checks = [("y", got[0], want[0], 5e-2 if bf16 else 1e-4),
                  ("sums", got[1], want[1], 1e-4)]
    elif name == "pair_bwd":
        checks = []
        for key, g, w in zip(("gu", "gs", "gt", "gw31", "gb31", "gw13",
                              "gb13"), got, want):
            if args[0] == "plain" and key in ("gs", "gt"):
                if float(g.abs().max()) != 0.0:
                    raise AssertionError(f"pair_bwd: {key} not 0 in plain")
                continue
            checks.append((key, g, w, 5e-2 if bf16 else 1e-3))
        # the weight and vector gradients sum terms of both signs over
        # all pixels, which cancel (gb13 feeds the next BatchNorm, which
        # removes any constant: it is zero up to rounding on the main
        # path): their error is taken relative to the size of the terms
        # summed. gu leaves out its 1e-3 share of elements with the largest
        # errors: where a pre-activation of the first conv lies within
        # rounding of 0 its ReLU mask can flip, and each flip moves the
        # 3 x C elements of gu that it reaches (192 at C=64) by up to their
        # full size
        scales = _pair_term_scales(torch, args)
        checks = [c[:4] + (scales.get(c[0], "quantile"),) for c in checks]
    elif name == "head_loss_fwd":
        checks = [("loss", got[0] / got[1], want[0] / want[1],
                   1e-2 if bf16 else 1e-5), ("wsum", got[1], want[1], 1e-6)]
    else:
        checks = [("dx", got[0], want[0], 5e-2 if bf16 else 1e-4),
                  ("dweight", got[1], want[1], 5e-2 if bf16 else 1e-3)]
    worst, abs_err, max_rel = {}, 0.0, {}
    for key, g, w, tol, *scale in checks:
        if not scale:
            err = rel_err(g, w)
        elif scale[0] == "quantile":
            d = (g.float() - w.float()).abs().reshape(-1)
            k = d.numel() - max(d.numel() // 1000, 1)
            top = w.float().abs().max()
            err = float(d.kthvalue(k).values / top)
            # logged, not gated: the share beyond the tolerance, the norm
            worst[f"{key}:share_beyond"] = float((d > tol * top).float()
                                                 .mean())
            worst[f"{key}:norm"] = float(d.norm() / w.float().norm())
        else:
            err = float((g.float() - w.float()).abs().max()) / max(
                float(w.float().abs().max()), scale[0])
        if not err <= tol:
            raise AssertionError(f"{name} ({label}) {key}: error {err:.3e} "
                                 f"> tolerance {tol:.1e}")
        worst[key] = err
        abs_err = max(abs_err, float((g.float() - w.float()).abs().max()))
        if key != "gb13":  # zero up to rounding on the main path
            max_rel[key] = rel_err(g, w)
    return worst, abs_err, max_rel


def _pair_term_scales(torch, args):
    """For the pair's weight and vector gradients, the largest sum of the
    magnitudes of the terms each adds up over the pixels: |gz u| (gs),
    |gz| (gt), |da| (gb31), |dy| (gb13); the weight gradients of |v|
    against |da| (gw31) and of |a| against |dy| (gw13). gz, da, dy from
    autograd of the plain pair with its intermediates kept."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    mode, u, s, t, w31, b31, w13, b13, gy, gsums = args
    dt = u.dtype

    def rnd(x):  # the plain version's rounding, identity gradient
        return x + (x.to(dt).float() - x).detach()

    with torch.enable_grad():
        uf = u.detach().permute(0, 3, 1, 2).float()
        z = (uf * s[:, None, None] + t[:, None, None] if mode == "affine"
             else uf).requires_grad_(True)
        v = rnd(F.relu(z)) if mode == "affine" else z
        k31 = w31.to(dt).float().permute(2, 1, 0)[..., None]
        k13 = w13.to(dt).float().permute(2, 1, 0)[:, :, None]
        z31 = F.conv2d(v, k31, b31.float(), padding=(1, 0))
        a = rnd(F.relu(z31))
        z13 = F.conv2d(a, k13, b13.float(), padding=(0, 1))
        y = rnd(z13)
        sums = torch.stack([y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))])
        gz, da, dy = torch.autograd.grad(
            (y, sums), (z, z31, z13), (gy.permute(0, 3, 1, 2).float(),
                                       gsums.float()))
    with torch.no_grad():
        dims = (0, 2, 3)
        return {
            "gs": float((gz * uf).abs().sum(dims).max()),
            "gt": float(gz.abs().sum(dims).max()),
            "gw31": float(conv2d_weight(v.detach().abs(), k31.shape,
                                        da.abs(), padding=(1, 0)).max()),
            "gb31": float(da.abs().sum(dims).max()),
            "gw13": float(conv2d_weight(a.detach().abs(), k13.shape,
                                        dy.abs(), padding=(0, 1)).max()),
            "gb13": float(dy.abs().sum(dims).max())}


def small_train_step(torch, tm):
    """One 96x128 R18 f32 b4 step on the card and on the CPU, same
    weights and batch, every NBt1D tail through the pairs. (At b2 the
    BatchNorms of the 3x4 maps at 1/32 normalize 24 values, and f32
    rounding reaches ~1e-4 in the instance losses.)"""
    report = {}
    min_pixels = tm.MIN_PIXELS
    tm.MIN_PIXELS = 0
    try:
        runs = {}
        for dev in ("cuda", "cpu"):
            model, _, step, batch, _, _ = train_setup(
                torch, 96, 128, "resnet18", 4, "float32", dev, False, seed=1)
            before = {k: v.detach().clone()
                      for k, v in model.named_parameters()}
            metrics = step(batch)
            runs[dev] = (metrics, before, model)
        (mc, bc, model_c), (mp, bp, model_p) = runs["cuda"], runs["cpu"]
        for key in mp:
            err = abs(float(mc[key]) - float(mp[key])) / abs(float(mp[key]))
            report[f"loss/{key}"] = err
            if err > 1e-4:
                raise AssertionError(f"small train step: loss {key} card vs "
                                     f"CPU {err:.2e} > 1e-4")
        for key, buf in model_p.named_buffers():
            got = dict(model_c.named_buffers())[key].cpu()
            if not torch.allclose(got, buf, atol=1e-4, rtol=1e-3):
                raise AssertionError(f"small train step: BN statistic {key} "
                                     "card vs CPU beyond atol 1e-4 / rtol "
                                     "1e-3")
        params_c = dict(model_c.named_parameters())
        num = den = 0.0
        worst = 0.0
        for key, p in model_p.named_parameters():
            dp = p.detach() - bp[key]
            dc = params_c[key].detach().cpu() - bc[key].cpu()
            d, r = float((dc - dp).norm()), float(dp.norm())
            num, den = num + d * d, den + r * r
            worst = max(worst, d / max(r, 1e-12) if r > 1e-6 else 0.0)
        report["update_rel"] = (num / den) ** 0.5
        report["update_worst_tensor"] = worst
        if report["update_rel"] > 5e-2 or worst > 0.5:
            raise AssertionError(f"small train step: parameter updates card "
                                 f"vs CPU {report['update_rel']:.2e} "
                                 f"(worst tensor {worst:.2e})")
    finally:
        tm.MIN_PIXELS = min_pixels
    log(f"[train] 96x128 R18 f32 b4 step, card vs CPU: {json.dumps(report)}")
    return report


def train_phase(torch, card):
    """Phase 7; returns the train kernels' JSON entries and a report."""
    from emsanet_tpu_torch.bench import time_cuda
    from emsanet_tpu_torch.ops import nbt1d_train as tm
    from emsanet_tpu_torch.ops import semantic_train_head as hm
    from emsanet_tpu_torch.train import dropout_generator_for

    torch.set_grad_enabled(True)
    modules = {"nbt1d_train": tm, "semantic_train_head": hm}
    report = {}
    model, _, step, batch, cfg, loader_s = train_setup(
        torch, 480, 640, "resnet34", 8, "bfloat16", "cuda", True)
    log(f"[train] loader host time per b8 batch (3 batches, 8 worker "
        f"threads, 640x480): {loader_s * 1e3:.1f} ms")
    report["loader_ms_per_batch"] = loader_s * 1e3

    # (a) the main path: 3 steps, launch counters from 0
    reset_counts(modules, TRAIN_KERNELS)
    totals = []
    with Capture(modules, TRAIN_KERNELS) as cap:
        for i in range(TRAIN_STEPS):
            metrics = step(batch, dropout_generator_for(0, 0, i, "cuda"))
            if i == 0:
                calls = {k: list(v) for k, v in cap.calls.items()}
            _finite_losses(metrics, f"train step {i}")
            totals.append(float(metrics["total_loss"]))
            log(f"[train] b8 640x480 bf16 step {i}: " + json.dumps(
                {k: round(float(v), 5) for k, v in metrics.items()}))
    torch.cuda.synchronize()
    launches = counts(modules, TRAIN_KERNELS)
    log(f"[train] launches over {TRAIN_STEPS} steps: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"train kernel {name} was not launched")
        if name in PAIR_DEVICE_KERNELS and n != PAIR_CALLS_PER_STEP * \
                TRAIN_STEPS:
            raise AssertionError(f"train kernel {name}: {n} launches over "
                                 f"{TRAIN_STEPS} steps, expected "
                                 f"{PAIR_CALLS_PER_STEP} per step")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"train loss did not fall: {totals}")
    log(f"[train] total loss step 0 {totals[0]:.5f} -> step "
        f"{TRAIN_STEPS - 1} {totals[-1]:.5f}: lower")
    report.update(launches=launches, total_loss=totals)

    # (b) each train kernel against its plain version, bf16 then f32; the
    # head-loss backward repeats bit for bit
    errors, max_abs, max_rel = {}, {}, {}
    for name, *_ in TRAIN_KERNELS:
        for args, _ in calls[name]:
            for label, a in (("bf16", args), ("f32", _train_f32(name, args))):
                if name.startswith("head_loss"):
                    fn = getattr(hm, name)
                    with torch.no_grad():
                        first, again = fn(*a), fn(*a)
                    torch.cuda.synchronize()
                    if not all(torch.equal(f, g) for f, g in zip(first,
                                                                 again)):
                        raise AssertionError(f"{name} ({label}): two calls "
                                             "differ")
                errs, abs_err, rel = compare_train(name, a, tm, hm, label)
                key = f"{name}/{label}"
                for out, err in errs.items():
                    k = f"{key}/{out}"
                    errors[k] = max(errors.get(k, 0.0), err)
                for out, r in rel.items():
                    k = f"{key}/{out}"
                    max_rel[k] = max(max_rel.get(k, 0.0), r)
                if label == "bf16":
                    max_abs[name] = max(max_abs.get(name, 0.0), abs_err)
    log(f"[train kernels vs plain] worst errors: {json.dumps(errors)}")
    log(f"[train kernels vs plain] worst errors relative to the max "
        f"(logged): {json.dumps(max_rel)}")
    report.update(errors=errors, errors_relative_to_max=max_rel)

    # (c) the small step, card vs CPU
    report["small_step"] = small_train_step(torch, tm)

    # (d) timing: the step, its profile, each kernel
    rounds = []
    for i in range(TRAIN_ROUNDS + 1):
        ms = time_cuda(lambda: step(batch, dropout_generator_for(
            0, 1, i, "cuda")), 0, 1)
        if i:  # the first round warms up
            rounds.append(ms)
    step_ms = statistics.median(rounds)
    log(f"[train] b8 640x480 bf16 step: median {step_ms:.2f} ms of "
        f"{TRAIN_ROUNDS} rounds ({min(rounds):.2f}-{max(rounds):.2f}); "
        f"{card}")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        wall_ms, rows = profile_frame(lambda b: step(b), batch)
        busy_ms = sum(r[0] for r in rows)
        short = [k for kernels in PAIR_DEVICE_KERNELS.values()
                 for k in kernels
                 if sum(r[1] for r in rows if k in r[2]) < PAIR_CALLS_PER_STEP]
        if busy_ms == 0 or not short:
            break
        log(f"[train] the profiled step's trace lacks launches of {short} "
            f"(attempt {attempt} of {PROFILE_ATTEMPTS})")
    log(f"[train] profiled step: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)" if busy_ms > 0
        else "[train] profiled step: no device time recorded: not measured")
    pair_dev = {name: sum(r[0] for r in rows
                          if any(k in r[2] for k in kernels))
                for name, kernels in PAIR_DEVICE_KERNELS.items()}
    if busy_ms > 0:
        # the bf16 pairs ran on the tensor-core kernels, once per call
        for kernels in PAIR_DEVICE_KERNELS.values():
            for k in kernels:
                ran = sum(r[1] for r in rows if k in r[2])
                if ran != PAIR_CALLS_PER_STEP:
                    raise AssertionError(f"profiled step: {k} ran {ran} "
                                         f"times, expected "
                                         f"{PAIR_CALLS_PER_STEP}")
        log(f"[train] profiled step: pair kernels' device time "
            f"{json.dumps(pair_dev)} ms, "
            f"{100 * sum(pair_dev.values()) / busy_ms:.1f}% of the device "
            f"time")
        loss_dev = {k: sum(r[0] for r in rows if k in r[2])
                    for k in ("head_loss_fwd_kernel", "head_loss_bwd_kernel")}
        report["head_loss_device_ms"] = loss_dev
        log(f"[train] profiled step: head-loss kernels' device time "
            f"{json.dumps(loss_dev)} ms")
    with open(os.path.join(OUT_DIR, "chip_smoke_train_profile.txt"),
              "w") as f:
        f.write(f"{card}\ntrain step b8 640x480 bf16: wall {wall_ms:.3f} "
                f"ms, device busy {busy_ms:.3f} ms\n")
        for ms, count, key in rows:
            f.write(f"{ms:10.4f} ms {count:6d}x  {key}\n")
    report.update(step_ms=step_ms, step_rounds=rounds,
                  profile={"wall_ms": wall_ms, "busy_ms": busy_ms,
                           "pair_device_ms": pair_dev})

    entries, detail = [], {}
    for name, mod, source, replaces in TRAIN_KERNELS:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "calls": 0,
               "bound_by": None, "ops": 0, "sites": []}
        for args, _ in calls[name]:
            kfn, pfn, byts, ops, odt = train_kernel_spec(name, args, tm, hm)
            with torch.no_grad():
                ms, plain = time_cuda(kfn, 2, 10), time_cuda(pfn, 2, 10)
            t_bytes = byts / PEAK_BYTES * 1e3
            t_ops = ops / PEAK_OPS[odt] * 1e3
            by = "bytes" if t_bytes >= t_ops else "operations"
            tot["bound_by"] = by if tot["bound_by"] in (None, by) \
                else "operations"
            tot["ms"] += ms
            tot["plain_ms"] += plain
            tot["bound_ms"] += max(t_bytes, t_ops)
            tot["ops"] += ops
            tot["calls"] += 1
            tot["sites"].append({"shape": list(args[1 if name.startswith(
                "pair") else 0].shape), "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops), "bound_by": by})
        detail[name] = tot
        log(f"[train kernel] {name}: {tot['calls']} calls per step, ms "
            f"{tot['ms']:.4f} plain {tot['plain_ms']:.4f} bound "
            f"{tot['bound_ms']:.4f} ({tot['bound_by']})")
        entry = {
            "name": TRAIN_NAMES[name], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_abs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": None, "batch": 8,
            # the step runs at b8 only; device time from the profiled step
            "ms_b1": None, "ms_b8": tot["ms"], "device_ms_b1": None,
            "device_ms_b8": (pair_dev.get(name) or report.get(
                "head_loss_device_ms", {}).get(f"{name}_kernel") or None),
        }
        if name in PAIR_DEVICE_KERNELS:
            entry.update(tflops=tot["ops"] / tot["ms"] / 1e9,
                         device_ms=pair_dev[name] or None)
            log(f"[train kernel] {name}: {entry['tflops']:.1f} TFLOP/s, "
                f"device {pair_dev[name]:.4f} ms per step")
        entries.append(entry)
    report["kernels"] = detail
    del model, calls, cap
    return entries, report


def main() -> int:
    try:
        return run()
    except Exception:  # report the failing phase, exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
