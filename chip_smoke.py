#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build: compile every kernel of `emsanet_tpu_torch/csrc` (one nvcc per
     source, all at once) and the loader's host library
     (`csrc/host/emsanet_native.cpp`, g++); `ptxas` must give both instantiations (bf16,
     f32) of the head-loss forward and backward kernels, the decoder
     trunk kernel, the stem kernel, the semantic decode kernel and the
     instance head kernel, the two (D = 1, 2) of the segment histogram
     kernel and its reduction kernel, the grouping kernel, the plane
     interleave kernel and the three (D = 1, 2, any) of the segment
     lookup kernel a 0-byte stack frame; their registers and shared
     memory are logged. A source whose library an earlier run built gives
     no ptxas report: it is compiled again, to a cubin in a temporary
     directory, so every gated kernel is checked on every run.
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
     off), with the tolerances below. The stem, the semantic decode, the
     segment histogram, the instance head, the grouping and the plane
     interleave must give the same bits in two calls on each of the
     decode-planes b8 frame's inputs.
 3b. lookup cases: the segment lookup kernel against its plain version,
     bit for bit, on `tests/torch_kernel_cases.py::LOOKUP_CASES` (keys
     below 0 and from S up, D = 1, 2, 3, P % 4 != 0, misaligned keys, a
     60 kB table).
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
 6c. grouping center sets: the grouping kernel against its plain version,
     bit for bit, on the decode-planes b8 frame's votes with three center
     sets: the frame's own, all 64 valid and 8 of 64 valid; its device ms
     with each is logged.
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
 7b. remat (`[remat]`, `--remat`): the flagship b8 640x480 bf16
     fused_training step without and with remat, from one state (seed
     0, dropout 0), each with the launch counters set to 0 just before:
     kernels 9 and 10 must launch in both; the losses equal to 1e-6, the
     parameters after the step within 2e-2 max abs (the step's backward
     is not deterministic on the card), the BatchNorm running statistics
     within 1e-3, each updated once (the recompute's BatchNorm calls
     update nothing); peak `torch.cuda.max_memory_allocated` and ms a
     step (CUDA events) logged for each.
  8. validation (`python -m emsanet_tpu_torch.train`'s loop): an R18
     96x128 f32 b2 model after 16 train steps on the card, evaluated
     on the card and, with the same weights, on the CPU: on every
     validation batch each eval output differs in at most 1e-3 of its
     elements (integers and bools that are not equal, floats beyond
     1e-3 + 1e-3 * |CPU|), and every metric of the validation within
     1e-4 (1e-2 degrees for the angular errors). The flagship
     with run 4's flags (results_samples/train_run_r5/run4_bce/argsv.txt:
     R34-NBt1D, 640x480, b8, 'auto' -> decode-planes) and
     `--mixed-precision` (bf16) trains 2 epochs and validates each into a
     temporary run directory (sanity check, checkpoints, metrics.csv); one
     more validation runs with the launch counters set to 0 just before it and
     read just after: kernels 1-7 (stem, chain, grouping, histogram,
     lookup, decode, instance head, interleave) must have launched; its
     metrics must be finite; its ms per batch is logged; a checkpoint
     saved and loaded on the card gives equal model and optimizer tensors.
  9. dataset (prepared datasets on disk, `python -m
     emsanet_tpu_torch.train --dataset-path`): a 640x480 dataset of the
     port's synthetic samples written with the port's PNG writer (24
     train samples; 4 test samples of each of two cameras, 480x640 and
     530x730; cameras.json, meta.json) and its packed copy must read
     back equal to the generator; the loader's host ms per b8 batch of
     the flagship's train preprocessing for thread and process workers
     on PNG and packed files (their batches equal bit for bit; a worker
     process must hold no CUDA driver or context), and the PNG reader's
     steps on one image, are logged. The flagship (bf16, b8,
     fused_training) trains 2 epochs from the PNG files with process
     workers, validating each epoch over both cameras ('auto' at
     validation batch 8 -> decode-planes); then a validation at full
     resolution (the second camera padded to 544x736) from the packed
     files through `--validation-only --weights-filepath`. Launch
     counters are set to 0 just before each and read just after: the
     training run must launch kernels 1-7, 9 and 10, the full-resolution
     validation 1-7; `finished`, finite losses and metrics. An R18 f32
     b2 model with two small cameras (96x128, 106x146) after 4 card steps
     is validated at full resolution on the card and the CPU: eval
     outputs and metrics within phase 8's limits.
 9b. prepare (`[prepare]`, `emsanet_tpu_torch/prepare_dataset.py`, on
     the host, without PIL): the port's JPEG decoder must equal the
     committed pixels (PIL's decode, as PNG) of every
     `tests/data/jpeg/*.jpg`; `prepare_cityscapes` on a 1024x2048 raw
     set the port writes itself (2 train, 1 val frames) must give the
     documented rgb, semantic, instance and depth maps; the synthetic
     set prepared at 640x480 is validated on the card through
     `train.main --validation-only` (the flagship R34 at full width,
     bf16, b2, decode-planes by 'auto'), kernels 1-8 launched.
 9c. resume and config (`[resume]`, `[config]`): `train.main(["resume",
     <phase 9's run>, "--n-epochs", "3"])` trains and validates one more
     epoch in a new run directory (kernels 1-7, 9, 10 launched; epoch 2
     alone in its metrics.csv, finite); `--config
     configs/nyuv2_multitask.json` with explicit flags parses to the
     file's values under them.
 10. inference (`python -m emsanet_tpu_torch.{import_torch_checkpoint,
     inference_samples,inference_dataset,inference_time}`): an
     upstream-layout `.pth` of the flagship's seed-0 weights (the port's
     names mapped back, 'model.' prefix, 'fused_encoders.' alias) goes
     through the import tool in a subprocess and must come out bit for
     bit; with it, the flagship (R34-NBt1D, 640x480, NYUv2's 40 classes,
     every task, panoptic) runs sample inference on two Kinect-v2-style
     pairs (480x640 and 540x960, depth in mm, some above --depth-max) in
     f32 and with --mixed-precision (launch counters set to 0 just before
     each run and read just after: kernels 1-5 and 8 must launch; panels
     of (960, 2560, 3) uint8; host ms per sample and step logged), and
     dataset inference over phase 9's PNG dataset (b8, bf16, 'auto' ->
     decode-planes, every format, --inference-output-fullres; kernels 1-7
     must launch; every file read back); an f32 sample and an f32 dataset
     run under torch.profiler give the chain's share of the device time.
     The small R18 96x128 f32 model runs both scripts on the card and on
     the CPU on the same files (limits: tests/torch_inference_cases.py);
     --visualize-validation must write the reference's 17 folders; the
     timing script's sweep (b1, b8, b32 x bf16, f32; 3 warmup and 10
     timed runs) is logged.
 11. variants (`[variants]`, the other model settings at 640x480, bf16,
     random weights from seed 0): the five-task model (R34-NBt1D, every
     task and normal, panoptic, hypersim's dataset config) at b1 and b2
     in 'decode' (one decoder-trunk launch over its three dense
     decoders, D = 3, at each) and b8 in 'decode-planes' (kernels 1-7,
     17 chain calls), three b8 fused_training steps with the normal loss
     (kernels 9 and 10, every loss finite); the rgbd (one stem of C = 4)
     and rgb-only (C = 3) R34-NBt1D encoders and the R50 dual encoder,
     b1 and b8 in 'decode-planes'. Launch counters are set to 0 just
     before each model's frames and read just after. Per model: ms per
     frame (median of 3 rounds of 5) and device busy of one profiled
     frame; the step's ms. Kernel cases against the plain versions, bf16
     and f32: the trunk with D = 3 at b1 and b2 and, where it ran, at
     R50 widths; the stem with one modality at C = 4, 3, 1, b1 and b8
     (the stem and the D = 3 trunk also bit for bit on repeat). Every
     setting of the CPU parity list (tests/test_torch_port_variants_*.py)
     as a small R18 96x128 f32 b2 frame, card against CPU, with phase 4's
     limits.
 12. data parallel (`[parallel]`, `emsanet_tpu_torch/parallel/`): (a)
     `dryrun_multichip(2, "cuda")`: two ranks on the one card over gloo
     (NCCL refuses two ranks on one card), the flagship (R34-NBt1D, bf16,
     fused_training, 640x480) at global b8 (b4 a rank) for 3 steps from
     the synthetic train data: on each rank kernels 9 and 10 launched
     (the Python launch counters, set to 0 before the steps), the
     parameters and BatchNorm buffers bit-identical across the ranks
     after every step, every loss finite; (b) the 2-rank sharded
     validation (global b8, b4 a rank) against one process on the same
     weights that evaluates the same images in calls of b4 (an image's
     outputs depend on the batch its convolutions and kernels run in):
     the eval step's maps equal (integer maps bit for bit), the logs
     equal; kernels 1-7 launched on each rank; (c) a checkpoint rank 0 saved and both ranks loaded holds the
     live parameters, buffers and optimizer state bit for bit and gives
     the next step's losses bit for bit (the step's backward is not
     deterministic on the card: the PPM's adaptive pooling and
     antialiased resize; the parameters' spread after it is logged);
     (d) world size 1 over NCCL through the same step: its first step's
     losses equal the plain step's bit for bit, and after 3 steps its
     parameters lie no farther from the closest of three plain runs
     than the farthest two plain runs lie apart. Logged:
     the step wall time at 2 ranks and at 1 process and the all-reduce's
     share (gloo through the host on one card says nothing of NCCL
     across cards).
 13. export (`[export]`, `emsanet_tpu_torch/export_model.py`): the
     flagship b1 bf16 frame with postprocessing (decode-planes, the trunk
     by 'auto') through `torch.export`: the graph holds the `emsanet::*`
     op of every kernel the live frame launches (1-8), the program saved
     and loaded back launches them, and its outputs equal the live
     frame's (integer and bool maps bit for bit, floats within 1e-5);
     the export's size and seconds and the loaded program's ms per call
     beside the live frame's are logged.

Tolerances (error relative to the largest magnitude of the plain result
unless stated): stem bf16 2e-2, f32 1e-4; NBt1D chain bf16 5e-2 (K
blocks; the plain version rounds every conv output to bf16, the kernel
only the conv pair's intermediate), f32 1e-4; grouping index and
distance bit-exact; histogram exact; vector sums 1e-4 (the kernel's
fixed order of sums is not the plain scatter_add's); lookup exact;
semantic decode f32 index exact and score 1e-5 relative, bf16 index
different on at most 1e-4 of the pixels and only where the plain
version's top two values are within one bf16 ulp,
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
dweight 5e-2 / 1e-3 (phase 11's cases take the same tolerances).
Small train step, card vs CPU: losses 1e-4
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
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# every traced span opens with this many spin kernels (`traced`)
TRACE_LEAD = 64
LEAD_KERNEL = "spin_kernel"
# (source, kernel, instantiations): ptxas must give each instantiation
# (bf16 and f32; the histogram's D = 1 and 2) no stack frame
STACK_FREE = (("semantic_train_head", "head_loss_fwd_kernel", 2),
              ("semantic_train_head", "head_loss_bwd_kernel", 2),
              ("decoder_trunk", "decoder_trunk_kernel", 2),
              ("stem", "stem_kernel", 2),
              ("semantic_decode", "semantic_decode_kernel", 2),
              ("segment", "hist_kernel", 2),
              ("segment", "hist_reduce_kernel", 1),
              ("instance_head", "instance_head_kernel", 2),
              ("grouping", "grouping_kernel", 1),
              ("plane_interleave", "plane_interleave_kernel", 1),
              ("segment", "lookup_kernel", 3))
# the bf16 stem must run on the tensor cores: its SASS (cuobjdump of the
# built library) must hold mma instructions
TENSOR_CORE_SASS = (("stem", "stem_kernel", "__nv_bfloat16"),)
TENSOR_CORE_OPS = ("HMMA", "HGMMA")
# kernels whose two calls on the flagship b8 frame's inputs must give the
# same bits (a fixed order of every float sum)
REPEAT_KERNELS = ("fused_stems", "semantic_decode", "segment_hist_and_sums",
                  "instance_head", "group_pixels_argmin", "interleave_planes")
# the grouping kernel's center sets on the b8 frame's votes: (name, number
# of valid centers; None: the frame's own)
GROUPING_CENTER_SETS = (("frame", None), ("64 valid", 64), ("8 valid", 8))


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


def _kernel_maps(named, pint):
    """The maps that `interleave_planes` sends through its kernel: 4-byte
    and 1-byte maps of width >= 2."""
    return [x for x in named.values()
            if x.dtype in pint.KERNEL_DTYPES and x.shape[-1] >= 2]


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
        byts = _nbytes(voted, centers, valid) + n * p * 8
        # 6 operations per pixel and valid center of its image: the
        # kernel walks those alone, so this run's centers set the work
        ops = 6 * p * int(valid.sum())
        return (lambda: grouping.group_pixels_argmin(voted, centers, valid),
                lambda: grouping.group_pixels_argmin_plain(voted, centers,
                                                           valid),
                None, byts, ops, "float32")
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
        maps = _kernel_maps(named, pint)
        # yardstick: one pixel_shuffle per map the kernel weaves (bool maps
        # as their bytes)
        shuffled = [x.view(torch.uint8) if x.dtype == torch.bool else x
                    for x in maps]
        return (lambda: pint.interleave_planes(named),
                lambda: pint.interleave_planes_plain(named),
                lambda: [F.pixel_shuffle(x, 2) for x in shuffled],
                2 * _nbytes(*maps), 0, "float32")
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
        from emsanet_tpu_torch import native as host_native
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
    t0 = time.time()
    host_native.get_lib()  # the loader's host library, built with g++
    log(f"[build] host library {host_native.library_path().name} in "
        f"{time.time() - t0:.1f} s")
    # a library built by an earlier run gives no ptxas report: those
    # sources are compiled again, to cubins in a temporary directory
    stale = sorted({src for src, *_ in STACK_FREE if not logs[src]})
    if stale:
        log(f"[build] {stale} were built by an earlier run: compiled again "
            "to cubins for ptxas' report")
        logs.update(ptxas_logs(_native, stale))
    for src, kernel, n_inst in STACK_FREE:
        props = ptxas_props(logs[src], kernel)
        log(f"[build] ptxas {kernel} (each instantiation): "
            + "; ".join(f"{p['name']}: {p['stack']} bytes stack, "
                        f"{p['registers']} registers, {p['smem']} bytes "
                        "static smem" for p in props))
        if len(props) != n_inst or any(p["stack"] for p in props):
            raise AssertionError(f"{kernel}: stack frames "
                                 f"{[p['stack'] for p in props]}, expected "
                                 f"0 bytes for each of {n_inst} "
                                 "instantiations")
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
            first, again = _outputs(kfn()), _outputs(kfn())
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{name}: two calls on the {TIMING_MODE}"
                                     " b8 frame's inputs differ")
        log(f"[kernel repeats] {name}: two calls on each of the "
            f"{TIMING_MODE} b8 frame's inputs are bit-identical")

    lookup_report = lookup_cases(torch, segment_kernels)

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
    # after the profiles: device_ms runs torch.profiler
    grouping_sets = grouping_center_sets(
        torch, captured[TIMING_MODE, "group_pixels_argmin", 8][0][0],
        ops_mod)
    # -- 7. train -------------------------------------------------------------
    del frames, captured, results
    torch.cuda.empty_cache()
    train_entries, train_report = train_phase(torch, card)
    entries.extend(train_entries)
    torch.cuda.empty_cache()
    remat_report = remat_phase(torch, card)
    # -- 8. validation ------------------------------------------------------
    torch.cuda.empty_cache()
    validation_report = validation_phase(torch, modules)
    # -- 9. prepared datasets on disk, 10. the inference scripts ------------
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        dataset_report = dataset_phase(torch, modules, tmp)
        torch.cuda.empty_cache()
        prepare_report = prepare_phase(torch, modules, tmp)
        torch.cuda.empty_cache()
        resume_report = resume_config_phase(
            torch, modules, dataset_report["run_dir"])
        torch.cuda.empty_cache()
        inference_report = inference_phase(torch, modules, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # -- 11. the other model settings ----------------------------------------
    torch.cuda.empty_cache()
    variants_report = variants_phase(torch, modules, ops_mod)
    # -- 12. data parallel, 13. export ---------------------------------------
    torch.cuda.empty_cache()
    parallel_report = parallel_phase(torch, card)
    torch.cuda.empty_cache()
    export_report = export_phase(torch, modules, time_cuda)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": card, "frame_ms": frame_ms, "detail": detail,
                   "launches": launches, "errors": errors,
                   "agreement_b8": agreement,
                   "small_frames": small, "profile": busy,
                   "trunk_on_off": trunk_report,
                   "library_device": library_device,
                   "chain_sites": chain_report,
                   "grouping_center_sets": grouping_sets,
                   "lookup_cases": lookup_report,
                   "train": train_report,
                   "remat": remat_report,
                   "validation": validation_report,
                   "dataset": dataset_report,
                   "prepare": prepare_report,
                   "resume_config": resume_report,
                   "inference": inference_report,
                   "variants": variants_report,
                   "parallel": parallel_report,
                   "export": export_report}, f, indent=1)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _ms(v):
    return "-" if v is None else f"{v:.4f}"


def _outputs(result):
    """A wrapper's result as a tuple of tensors."""
    if isinstance(result, dict):
        return tuple(result.values())
    return tuple(result) if isinstance(result, (tuple, list)) else (result,)


def grouping_center_sets(torch, args, ops_mod):
    """The grouping kernel against its plain version (bit for bit, via
    `compare`) on one call's votes of the b8 frame with each center set of
    GROUPING_CENTER_SETS, and its device ms with each. The other sets keep
    the frame's valid centers where they are and put the rest at random
    places in the frame (seed 0); '8 valid' keeps 8 slots spread over K."""
    voted, centers, valid = args
    n, k, _ = centers.shape
    gen = torch.Generator(device=centers.device).manual_seed(0)
    spots = torch.stack(
        [torch.randint(0, 480, (n, k), generator=gen, device=centers.device),
         torch.randint(0, 640, (n, k), generator=gen, device=centers.device)],
        -1).float()
    placed = torch.where(valid[..., None], centers, spots).contiguous()
    report = {}
    for name, n_valid in GROUPING_CENTER_SETS:
        if n_valid is None:
            set_args = (voted, centers, valid)
        else:
            keep = torch.zeros_like(valid)
            keep[:, torch.arange(n_valid) * (k // n_valid)] = True
            set_args = (voted, placed, keep)
        compare("group_pixels_argmin", set_args, {}, ops_mod, "f32")
        kfn, _, _, byts, ops, odt = kernel_spec("group_pixels_argmin",
                                                set_args, {}, ops_mod)
        report[name] = {
            "valid_per_image": set_args[2].sum(1).tolist(),
            "device_ms": device_ms(kfn),
            "bound_ms": max(byts / PEAK_BYTES, ops / PEAK_OPS[odt]) * 1e3}
        log(f"[grouping centers] {name}: valid per image "
            f"{report[name]['valid_per_image']}, equal to plain, device ms "
            f"{report[name]['device_ms']:.4f}, bound "
            f"{report[name]['bound_ms']:.4f}")
    return report


def lookup_cases(torch, seg):
    """The lookup kernel against its plain version, bit for bit, on the
    cases of `tests/torch_kernel_cases.py::LOOKUP_CASES`: keys below 0
    and from S up, D = 1, 2 and 3, P % 4 != 0, keys 4 bytes off a 16-byte
    boundary, a table above 48 kB."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_kernel_cases as kc

    report = {}
    for name in kc.LOOKUP_CASES:
        keys, tables, misaligned = kc.lookup_case(name)
        n, p = keys.shape
        flat = torch.from_numpy(keys).cuda().reshape(-1)
        if misaligned:
            buf = torch.zeros(n * p + 1, dtype=torch.int32, device="cuda")
            buf[1:] = flat
            flat = buf[1:]
        inst = flat.view(n, p)
        tab = torch.from_numpy(tables).cuda()
        got = seg.segment_lookup(inst, tab)
        want = seg.segment_lookup_plain(inst, tab)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"segment_lookup, case {name}: differs from "
                                 "the plain version")
        report[name] = {"n": n, "p": p, "d": tables.shape[1],
                        "s": tables.shape[2], "misaligned": misaligned,
                        "keys_out_of_range": int(((keys < 0) | (
                            keys >= tables.shape[2])).sum())}
    log(f"[lookup cases] equal to the plain version bit for bit: "
        f"{json.dumps(report)}")
    return report


# card vs CPU on the small model: each eval output key may differ in at
# most this share of its elements (an integer or bool element that
# differs, a float one beyond atol + rtol * |CPU|), and each metric by
# at most this much (the largest gap seen: 1.7e-5)
VALIDATION_OUT_TOL = {"share": 1e-3, "atol": 1e-3, "rtol": 1e-3}
VALIDATION_TOL = {"ratio": 1e-4, "deg": 1e-2}
VALIDATION_SMALL_EPOCHS = 8  # of 2 steps, before the card-vs-CPU check


def validation_phase(torch, modules):
    """Phase 8: validation in the port's trainer. (a) R18 96x128 f32 b2,
    4 synthetic samples: 8 epochs of 2 train steps on the card, then,
    with the same weights on the card and on the CPU (plain versions),
    the eval step's outputs on every validation batch, each key within
    VALIDATION_OUT_TOL (a few of the 2 x 12,288 pixels may flip where
    the f32 outputs of the two devices straddle a decision), and
    `run_validation`'s metrics within VALIDATION_TOL.
    (b) The flagship with run 4's flags (R34-NBt1D, 640x480, b8, overfit
    on one batch, validation on it) and bf16 mixed precision (run 4 itself
    computes in f32) for 2 epochs,
    validating each: the trainer's whole loop into a temporary run
    directory; then one more validation with the launch counters set to
    0 just before it and read just after (kernels 1-7 must have
    launched; the trunk, 8, runs at batch <= 2 only), finite metrics, its
    ms per validation batch; a checkpoint saved and loaded on the card
    gives equal tensors."""
    from emsanet_tpu_torch import config as pc
    from emsanet_tpu_torch import train as trainer
    from emsanet_tpu_torch.training.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from emsanet_tpu_torch.training.step import extract_device_batch

    torch.set_grad_enabled(True)
    report = {}
    # (a) card against CPU
    small = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(
            tasks=("semantic", "instance", "orientation", "scene"),
            enable_panoptic=True, input_height=96, input_width=128,
            rgb_encoder_backbone="resnet18",
            depth_encoder_backbone="resnet18", fused_training=True,
            fused_inference=True,
            head_decode_fusion=pc.best_head_decode_fusion(2)),
        data=pc.DataConfig(dataset="synthetic", batch_size=2,
                           validation_batch_size=2, synthetic_n_samples=4,
                           n_workers=4, class_weighting="none"),
        train=pc.TrainConfig(seed=0)))
    card_run = trainer.setup(small, "cuda")
    for epoch in range(VALIDATION_SMALL_EPOCHS):
        for i, batch in enumerate(card_run.data.train_loader.batches(epoch)):
            card_run.train_step(
                extract_device_batch(batch, "cuda"),
                trainer.dropout_generator_for(0, epoch, i, "cuda"))
    cpu_run = trainer.setup(small, "cpu")
    cpu_run.model.load_state_dict({k: v.cpu() for k, v in
                                   card_run.model.state_dict().items()})
    outs = eval_outputs_card_vs_cpu(torch, trainer, card_run, cpu_run)
    log(f"[validation] R18 96x128 f32 b2, eval outputs card vs CPU "
        f"(share of elements that differ, largest float error): "
        f"{json.dumps(outs)}")
    on_card = trainer.run_validation(card_run, 0)
    on_cpu = trainer.run_validation(cpu_run, 0)
    diffs = metrics_card_vs_cpu(on_card, on_cpu, "[validation]")
    log(f"[validation] R18 96x128 f32 b2, card vs CPU after "
        f"{2 * VALIDATION_SMALL_EPOCHS} card steps: "
        f"card {json.dumps(on_card)}; largest difference "
        f"{max(diffs.values()):.3e} ({max(diffs, key=diffs.get)})")
    report["card_vs_cpu"] = {"card": on_card, "cpu": on_cpu,
                             "outputs": outs}
    del card_run, cpu_run

    # (b) the flagship with run 4's flags
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results_samples", "train_run_r5", "run4_bce",
                           "argsv.txt")) as fh:
        argv = fh.read().split()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, _, used = trainer.parse_args(
            argv + ["--mixed-precision", "--n-epochs", "2",
                    "--validation-force-interval", "1",
                    "--results-basepath", tmp])
        t0 = time.perf_counter()
        run = trainer.setup(cfg, "cuda")
        run_dir = trainer.make_run_dir(cfg, used)
        logs = trainer.train(run, run_dir)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        with open(os.path.join(run_dir, "metrics.csv")) as fh:
            rows = fh.read().strip().splitlines()
        if len(rows) != 3 or "valid_semantic_miou" not in rows[0]:
            raise AssertionError(f"[validation] metrics.csv of the 2-epoch "
                                 f"run: {rows[:1]}, {len(rows)} lines")
        (loader,) = run.data.valid_loaders.values()
        n_batches = len(loader)
        reset_counts(modules)
        t1 = time.perf_counter()
        valid = trainer.run_validation(run, 2)
        torch.cuda.synchronize()
        valid_s = time.perf_counter() - t1
        launches = counts(modules)
        missing = [name for name in PATH_KERNELS["decode-planes"]
                   if name != "decoder_trunk" and launches[name] <= 0]
        if missing:
            raise AssertionError(f"[validation] kernels {missing} were not "
                                 "launched by the flagship's validation")
        bad = [k for k, v in {**logs, **valid}.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"[validation] non-finite metrics {bad}")
        path = os.path.join(tmp, "ckpt.pt")
        save_checkpoint(path, run.model, run.optimizer, 1, logs)
        other = trainer.setup(cfg, "cuda")
        load_checkpoint(path, other.model, other.optimizer)
        for (k, a), (_, b) in zip(run.model.state_dict().items(),
                                  other.model.state_dict().items()):
            if not torch.equal(a, b):
                raise AssertionError(f"[validation] checkpoint: {k} differs")
        sa = run.optimizer.state_dict()["state"]
        sb = other.optimizer.state_dict()["state"]
        if sorted(sa) != sorted(sb) or not all(
                torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]
                if torch.is_tensor(sa[i][k])):
            raise AssertionError("[validation] checkpoint: the optimizer "
                                 "state differs")
    ms_batch = valid_s * 1e3 / n_batches
    log(f"[validation] flagship R34 640x480 bf16 b8, run 4's flags, 2 "
        f"epochs validating each: {loop_s:.1f} s (sanity check, setup and "
        f"loop); epoch 1 {json.dumps(logs)}")
    log(f"[validation] one more validation: {n_batches} batch(es), "
        f"{ms_batch:.1f} ms per batch of 8; launches "
        f"{json.dumps(launches)}; checkpoint saved and loaded on the card: "
        "equal tensors")
    report["flagship"] = {"epoch_1": logs, "again": valid,
                          "ms_per_batch": ms_batch, "launches": launches,
                          "loop_s": loop_s, "head_decode_fusion":
                              cfg.model.head_decode_fusion}
    torch.set_grad_enabled(False)
    return report


def metrics_card_vs_cpu(on_card, on_cpu, where):
    """Each validation metric of the card's run against the CPU's: both
    finite and within VALIDATION_TOL; returns the differences."""
    diffs = {}
    for key, want in on_cpu.items():
        got = on_card[key]
        if not (math.isfinite(got) and math.isfinite(want)):
            raise AssertionError(f"{where} {key}: not finite "
                                 f"(card {got}, CPU {want})")
        tol = VALIDATION_TOL["deg" if key.endswith("_deg") else "ratio"]
        diffs[key] = abs(got - want)
        if diffs[key] > tol:
            raise AssertionError(f"{where} {key}: card {got} against "
                                 f"CPU {want}, beyond {tol}")
    return diffs


def eval_outputs_card_vs_cpu(torch, trainer, card_run, cpu_run):
    """The eval step of the card's run and of the CPU's on each
    validation batch of every camera's loader: per output key, the share
    of elements that differ (integer and bool elements that are not
    equal, float ones beyond VALIDATION_OUT_TOL's atol + rtol * |CPU|,
    non-finite ones where the other side differs) and the largest float
    error; raises where a share is above VALIDATION_OUT_TOL['share']."""
    tol = VALIDATION_OUT_TOL
    worst = {}
    batches = [b for loader in cpu_run.data.valid_loaders.values()
               for b in loader.batches(0)]
    for batch in batches:
        inputs = {k: torch.from_numpy(batch[k]) for k in trainer.EVAL_KEYS
                  if k in batch}
        want = cpu_run.eval_step(inputs)
        got = card_run.eval_step({k: v.to(card_run.device)
                                  for k, v in inputs.items()})
        if sorted(got) != sorted(want):
            raise AssertionError(f"[validation] eval output keys: card "
                                 f"{sorted(got)}, CPU {sorted(want)}")
        for k, w in want.items():
            g = got[k].cpu()
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(
                    f"[validation] eval output {k}: card {g.dtype} "
                    f"{tuple(g.shape)}, CPU {w.dtype} {tuple(w.shape)}")
            err = 0.0
            if w.is_floating_point():
                off = ~torch.isclose(g, w, rtol=tol["rtol"],
                                     atol=tol["atol"], equal_nan=True)
                both = torch.isfinite(g) & torch.isfinite(w)
                if both.any():
                    err = float((g[both] - w[both]).abs().max())
            else:
                off = g != w
            share = float(off.float().mean()) if off.numel() else 0.0
            share = max(share, worst.get(k, {}).get("share", 0.0))
            err = max(err, worst.get(k, {}).get("max_abs_err", 0.0))
            worst[k] = {"share": share, "max_abs_err": err}
    bad = {k: v for k, v in worst.items() if v["share"] > tol["share"]}
    if bad:
        raise AssertionError(f"[validation] eval outputs card vs CPU beyond "
                             f"{json.dumps(tol)}: {json.dumps(bad)}")
    return worst


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


def ptxas_logs(native, sources):
    """`ptxas -v`'s report of each source, compiled afresh to a cubin in a
    temporary directory (one nvcc each, all at once)."""
    flags = [f for f in native.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [native._nvcc(), *flags, "-cubin", "-o",
             os.path.join(tmp, f"{src}.cubin"),
             str(native.CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources}
        out = {}
        for src, proc in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"nvcc -cubin failed for {src}:\n{text}")
            out[src] = text
    return out


def ptxas_props(build_log, kernel):
    """`ptxas -v`'s stack frame, registers and static shared memory of
    each instantiation of kernel (mangled names: the f32 and the bf16 one,
    or one per integer template argument)."""
    import re

    out, lines = [], build_log.splitlines()
    for i, line in enumerate(lines[:-2]):
        if ("Function properties for" in line
                and re.search(rf"\d{kernel}[EI]", line)):
            used = lines[i + 2]
            regs = re.search(r"Used (\d+) registers", used)
            smem = re.search(r"(\d+) bytes smem", used)
            arg = re.search(rf"{kernel}ILi(\d+)E", line)
            out.append({
                "name": ("bf16" if "bfloat16" in line
                         else f"<{arg.group(1)}>" if arg
                         else "f32" if f"{kernel}IfE" in line else "-"),
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


def traced(body, activities):
    """(torch.profiler trace, wall ms of body) of one span. A trace loses
    the first few device records of its span, and more the longer the
    process has run (on the H100: none at 80 s, 2-3 after the training
    and validation phases, every record of a 10-call span in phase 11):
    each span opens with TRACE_LEAD spin kernels, and counts only where
    one of them is left, so the records after them are whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    lead = TRACE_LEAD
    while True:
        with profile(activities=activities) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            body()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if any(LEAD_KERNEL in ev.key for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA):
            return prof, wall_ms
        if lead >= 16 * TRACE_LEAD:
            raise AssertionError(f"torch.profiler kept none of the {lead} "
                                 "spin kernels that open its trace")
        lead *= 4


def device_rows(prof):
    """[(device ms, count, kernel name)] of a trace, longest first: the
    spin kernels and the user annotations (the optimizer's step range,
    which spans kernels counted on their own) left out."""
    from torch.autograd import DeviceType

    return sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0
                   and LEAD_KERNEL not in ev.key
                   and not ev.key.startswith("Optimizer.")), reverse=True)


def device_ms(fn, runs=10):
    """Device milliseconds per call of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    prof, _ = traced(lambda: [fn() for _ in range(runs)],
                     [ProfilerActivity.CUDA])
    return sum(r[0] for r in device_rows(prof)) / runs


def profile_frame(frame, batch):
    """(wall ms, [(device ms, count, kernel name)]) of one frame."""
    from torch.profiler import ProfilerActivity

    prof, wall_ms = traced(lambda: frame(batch), [ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
    return wall_ms, device_rows(prof)


# ---------------------------------------------------------------------------
# 7. training


def train_setup(torch, height, width, backbone, batch_size, dtype, device,
                dropout, seed=0,
                tasks=("semantic", "instance", "orientation", "scene"),
                **model):
    """(model, optimizer, step, device batch, cfg, loader seconds per
    batch) of a synthetic-data training configuration: the first of 3
    batches drawn through the train preprocessor and the loader."""
    from emsanet_tpu_torch import config as pc
    from emsanet_tpu_torch.data import DataLoader
    from emsanet_tpu_torch.datasets.metadata import get_dataset_config
    from emsanet_tpu_torch.datasets.registry import get_dataset
    from emsanet_tpu_torch.models.emsanet import build_train_model
    from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
    from emsanet_tpu_torch.training.optim import get_optimizer
    from emsanet_tpu_torch.training.step import (
        extract_device_batch,
        make_train_step,
    )

    drop = {} if dropout else {
        "dropout_p": 0.0, "semantic_decoder_block_dropout_p": 0.0,
        "instance_decoder_block_dropout_p": 0.0,
        "normal_decoder_block_dropout_p": 0.0}
    cfg = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(
            tasks=tasks, enable_panoptic=True, input_height=height,
            input_width=width,
            rgb_encoder_backbone=backbone, depth_encoder_backbone=backbone,
            fused_training=True, **drop, **model),
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


# phase 9: prepared datasets on disk. The flagship's dataset: 24 train
# samples at 480x640 and, in 'test', 4 samples of each camera, the second
# of SUNRGB-D's Kinect v2 size (530x730, padded to 544x736 at full
# resolution); PNG rows filtered per row as libpng and PIL choose
DATASET_TRAIN = 24
DATASET_VALID_PER_CAMERA = 4
DATASET_CAMERAS = (("kv1", 480, 640), ("kv2", 530, 730))
SMALL_CAMERAS = (("kv1", 96, 128), ("kv2", 106, 146))  # card vs CPU
PNG_FILTER = "adaptive"
LOADER_WORKERS = 8
# what a loader worker process has loaded: torch or JAX (multiprocessing
# imports the launching script's main module in it), the CUDA driver, a
# CUDA context; the last two must be absent
WORKER_PROBE = ("(sorted(__import__('sys').modules.keys() & {'torch', "
                "'jax'}), 'libcuda' in open('/proc/self/maps').read(), "
                "'torch' in __import__('sys').modules and "
                "__import__('torch').cuda.is_initialized())")


def write_prepared(root, n_train, cameras, n_valid):
    """A prepared dataset (the layout `datasets/disk.py` reads) of the
    port's synthetic samples: `n_train` in 'train' at the first camera's
    size, `n_valid` of each camera (name, h, w) in 'test' with ids
    '<camera index><nnn>', cameras.json and meta.json. Returns the
    samples by (split, id)."""
    import numpy as np

    from emsanet_tpu_torch.datasets.metadata import (
        dataset_config_to_meta,
        get_dataset_config,
    )
    from emsanet_tpu_torch.datasets.png import write_png
    from emsanet_tpu_torch.datasets.synthetic import SyntheticDataset

    written = {}

    def put(split, sid, s):
        base = os.path.join(root, split)
        for kind, arr in (
                ("rgb", s["rgb"]),
                ("depth", np.clip(s["depth"], 0, 65535).astype(np.uint16)),
                ("semantic_40", s["semantic"].astype(np.uint8)),
                ("instance", s["instance"].astype(np.uint16))):
            write_png(os.path.join(base, kind, f"{sid}.png"), arr,
                      PNG_FILTER)
        for kind, ext, text in (
                ("orientations", "json", json.dumps(
                    {str(k): v for k, v in s["orientations"].items()})),
                ("scene_class", "txt", str(s["scene"]))):
            os.makedirs(os.path.join(base, kind), exist_ok=True)
            with open(os.path.join(base, kind, f"{sid}.{ext}"), "w") as fh:
                fh.write(text)
        written[split, sid] = s

    _, h, w = cameras[0]
    ds = SyntheticDataset("train", n_samples=n_train, height=h, width=w)
    for i in range(n_train):
        put("train", f"{i:04d}", ds.load_raw(i))
    camera_of = {}
    for c, (name, h, w) in enumerate(cameras):
        ds = SyntheticDataset(f"test{c}", n_samples=n_valid, height=h,
                              width=w)
        for i in range(n_valid):
            put("test", f"{c}{i:03d}", ds.load_raw(i))
            camera_of[f"{c}{i:03d}"] = name
    with open(os.path.join(root, "test", "cameras.json"), "w") as fh:
        json.dump(camera_of, fh)
    with open(os.path.join(root, "meta.json"), "w") as fh:
        json.dump(dataset_config_to_meta(get_dataset_config("synthetic")),
                  fh)
    return written


def check_raw_samples(root, written):
    """Every sample read back from disk equals the generator's, bit for
    bit (depth as the uint16 it was written as)."""
    import numpy as np

    from emsanet_tpu_torch.datasets.disk import PreparedDataset

    keys = ("identifier", "rgb", "depth", "semantic", "instance",
            "orientations", "scene")
    n = 0
    for split in ("train", "test"):
        ds = PreparedDataset(root, "nyuv2", split, keys,
                             scene_use_indoor_domestic_labels=True)
        for i in range(len(ds)):
            got = ds.load_raw(i)
            want = written[split, got["identifier"][1]]
            depth = np.clip(want["depth"], 0, 65535).astype(
                np.uint16).astype(np.float32)
            same = (np.array_equal(got["rgb"], want["rgb"])
                    and np.array_equal(got["depth"], depth)
                    and np.array_equal(got["semantic"], want["semantic"])
                    and np.array_equal(got["instance"], want["instance"])
                    and got["orientations"] == want["orientations"]
                    and got["scene"] == want["scene"])
            if not same:
                raise AssertionError(f"[dataset] {split}/{i} read back from "
                                     f"{root} differs from the generator's")
            n += 1
    return n


def loader_times(torch, roots, cfg):
    """Host ms per b8 train batch (an epoch of 3 batches of the flagship's
    train preprocessing, LOADER_WORKERS workers; epochs 0 and 1) for
    thread and process workers on the PNG and the packed files; every
    combination's epoch-0 batches must equal the first's bit for bit.
    Also: packed reads on one thread, the PNG reader's steps on one
    640x480 RGB image, and what a worker process has loaded."""
    import zlib

    import numpy as np

    from emsanet_tpu_torch import native
    from emsanet_tpu_torch.data import DataLoader, _process_pool
    from emsanet_tpu_torch.datasets import png
    from emsanet_tpu_torch.datasets.registry import (
        get_dataset,
        get_dataset_config,
    )
    from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor

    def same(a, b):
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(same(a[k], b[k])
                                                  for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    report, first = {}, None
    pre = get_preprocessor(cfg, get_dataset_config(cfg.data), "train",
                           multiscale_downscales=(
                               cfg.model.side_output_downscales))
    for files, root in roots.items():
        cfg.data.dataset_path = root
        ds = get_dataset(cfg.data, cfg.model, "train")
        ds.preprocessor = pre
        for mode, workers in (("thread", LOADER_WORKERS),
                              ("process", LOADER_WORKERS),
                              ("thread", 1)):
            if workers == 1 and files != "packed":
                continue
            loader = DataLoader(ds, 8, shuffle=True, drop_last=True,
                                n_workers=workers, seed=0, worker_mode=mode)
            # epoch 0 starts a process loader's workers, epoch 1 reuses them
            for epoch in (0, 1):
                t0 = time.perf_counter()
                batches = list(loader.batches(epoch))
                ms = (time.perf_counter() - t0) * 1e3 / len(batches)
                key = f"{files}/{mode}/{workers}/epoch{epoch}"
                report[key] = ms
                if first is None:
                    first = batches
                elif epoch == 0 and not same(batches, first):
                    raise AssertionError(f"[dataset] loader {key}: batches "
                                         "differ from the first "
                                         "combination's")
                del batches
            loader.close()
    with _process_pool(ds, 1) as pool:
        modules, driver, context = pool.submit(eval, WORKER_PROBE).result()
    report["worker_process"] = {"torch_or_jax": modules,
                                "libcuda_mapped": driver,
                                "cuda_initialized": context}
    if driver or context:
        raise AssertionError(f"[dataset] a loader worker process holds "
                             f"CUDA: {report['worker_process']}")
    del first
    # the PNG reader's steps on one RGB image of the train split
    path = os.path.join(roots["png"], "train", "rgb", "0000.png")
    raw = png.read_png(path)
    raw = raw.reshape(raw.shape[0], -1)
    steps = {}
    for f in (0, 1, 2, 3, 4, PNG_FILTER):
        stream = png.filter_rows(raw, 3, f)
        steps[f"unfilter_{f}"] = _median_ms(
            lambda: native.png_unfilter(stream, *raw.shape, 3))
    with open(path, "rb") as fh:
        blob = fh.read()
    idat = zlib.compress(png.filter_rows(raw, 3, PNG_FILTER))
    steps["inflate"] = _median_ms(lambda: zlib.decompress(idat))
    steps["read_png"] = _median_ms(lambda: png.read_png(path))
    report["png_rgb_ms"] = steps
    report["png_rgb_bytes"] = len(blob)
    return report


def _median_ms(fn, runs=7):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dataset_phase(torch, modules, tmp):
    """Phase 9: training and validation from prepared datasets on disk,
    written under `tmp` (`png/`, `packed/`, `small/`; phase 10 reads
    them).
    (a) A 640x480 dataset written with the port's PNG writer, read back
    equal to the generator; its packed copy (`datasets/pack.py`); the
    loader's ms per b8 batch for thread and process workers on PNG and
    packed files, every combination's batches equal bit for bit.
    (b) The flagship bf16 b8 `--fused-training` trains 2 epochs from the
    PNG files with process workers, validating each epoch over both
    cameras (decode-planes at validation batch 8); then a validation at
    full resolution (544x736 for the second camera) through
    `--validation-only --weights-filepath`. Each with the launch counters
    set to 0 just before and read just after: the training run must
    launch kernels 1-7, 9 and 10, the full-resolution validation 1-7;
    `finished`, finite losses and metrics. (c) R18 96x128 f32 b2 with two
    cameras (96x128, 106x146), 4 card steps, then the eval outputs and
    the metrics of a full-resolution validation, card against CPU, under
    phase 8's limits."""
    from emsanet_tpu_torch import train as trainer
    from emsanet_tpu_torch.datasets import pack
    from emsanet_tpu_torch.ops import nbt1d_train as tm
    from emsanet_tpu_torch.ops import semantic_train_head as hm
    from emsanet_tpu_torch.training.step import extract_device_batch

    torch.set_grad_enabled(True)
    all_modules = {**modules, "nbt1d_train": tm, "semantic_train_head": hm}
    all_kernels = KERNELS + TRAIN_KERNELS
    report = {}
    # (a) write, read back, pack, time the loader
    t0 = time.perf_counter()
    roots = {"png": os.path.join(tmp, "png"),
             "packed": os.path.join(tmp, "packed")}
    written = write_prepared(roots["png"], DATASET_TRAIN,
                             DATASET_CAMERAS, DATASET_VALID_PER_CAMERA)
    n = check_raw_samples(roots["png"], written)
    shutil.copytree(roots["png"], roots["packed"])
    for split in ("train", "test"):
        pack.pack_split(roots["packed"], split)
    n_packed = check_raw_samples(roots["packed"], written)
    del written
    log(f"[dataset] wrote {n} samples (PNG, {PNG_FILTER} row filters) "
        f"and their packed copy in {time.perf_counter() - t0:.1f} s; "
        f"read back equal to the generator: {n} PNG, {n_packed} packed")
    flags = ["--dataset", "nyuv2", "--tasks", "semantic", "instance",
             "orientation", "scene", "--enable-panoptic",
             "--mixed-precision", "--fused-training", "--fused-inference",
             "--batch-size", "8", "--validation-batch-size", "8",
             "--head-decode-fusion", "auto", "--n-workers",
             str(LOADER_WORKERS), "--validation-force-interval", "1"]
    cfg, _, _ = trainer.parse_args(flags + ["--dataset-path",
                                            roots["png"]])
    loader = loader_times(torch, roots, cfg)
    log(f"[dataset] loader host ms per b8 batch (flagship train "
        f"preprocessing, 640x480, 3 batches; files/workers/count), "
        f"all equal bit for bit: " + json.dumps(
            {k: round(v, 1) for k, v in loader.items()
             if isinstance(v, float)}))
    log(f"[dataset] a loader worker process: "
        f"{json.dumps(loader['worker_process'])}; PNG reader steps on "
        f"one 480x640 RGB image ({loader['png_rgb_bytes']} bytes), ms: "
        + json.dumps({k: round(v, 3) for k, v in
                      loader["png_rgb_ms"].items()}))
    report["loader_ms_per_b8_batch"] = loader

    # (b) the flagship from disk, process workers
    runs = os.path.join(tmp, "runs")
    cfg, _, used = trainer.parse_args(flags + [
        "--dataset-path", roots["png"], "--worker-mode", "process",
        "--n-epochs", "2", "--results-basepath", runs])
    t0 = time.perf_counter()
    run = trainer.setup(cfg, "cuda")
    run_dir = trainer.make_run_dir(cfg, used)
    setup_s = time.perf_counter() - t0
    reset_counts(all_modules, all_kernels)
    t0 = time.perf_counter()
    logs = trainer.train(run, run_dir)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = counts(all_modules, all_kernels)
    need = (PATH_KERNELS["decode-planes"] - {"decoder_trunk"}) | {
        name for name, *_ in TRAIN_KERNELS}
    missing = sorted(k for k in need if launches[k] <= 0)
    if missing:
        raise AssertionError(f"[dataset] kernels {missing} were not "
                             "launched by the run from disk")
    if not os.path.exists(os.path.join(run_dir, "finished")):
        raise AssertionError("[dataset] the run from disk did not finish")
    with open(os.path.join(run_dir, "metrics.csv")) as fh:
        header, *rows = [r.split(",") for r in
                         fh.read().strip().splitlines()]
    epochs = [dict(zip(header, r)) for r in rows]
    bad = [k for e in epochs for k, v in e.items()
           if k.startswith(("train_", "valid_"))
           and not math.isfinite(float(v))]
    if len(epochs) != 2 or bad:
        raise AssertionError(f"[dataset] metrics.csv: {len(epochs)} "
                             f"epochs, not finite: {bad}")
    times = {k: [float(e[k]) for e in epochs]
             for k in ("time_train_s", "time_valid_s")}
    log(f"[dataset] flagship R34 640x480 bf16 b8 from PNG files, process "
        f"workers, 2 epochs of {len(run.data.train_loader)} steps, "
        f"validating each over {list(run.data.valid_loaders)}: setup "
        f"{setup_s:.1f} s, loop {loop_s:.1f} s (sanity check included); "
        f"epoch s {times['time_train_s']}, validation s "
        f"{times['time_valid_s']}; launches {json.dumps(launches)}; "
        f"epoch 1 {json.dumps(logs)}")
    report["flagship"] = {"setup_s": setup_s, "loop_s": loop_s,
                          **times, "launches": launches,
                          "epoch_1": logs}
    report["run_dir"] = run_dir  # phase 9c resumes it
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt_resume.pt")
    del run
    torch.cuda.empty_cache()
    cfg, _, used = trainer.parse_args(flags + [
        "--dataset-path", roots["packed"], "--validation-only",
        "--validation-full-resolution", "--skip-sanity-check",
        "--weights-filepath", ckpt, "--results-basepath", runs])
    run = trainer.setup(cfg, "cuda")
    shapes = sorted({tuple(b["rgb"].shape[1:3]) for loader in
                     run.data.valid_loaders.values()
                     for b in loader.batches(0)})
    reset_counts(all_modules, all_kernels)
    t0 = time.perf_counter()
    valid = trainer.train(run, trainer.make_run_dir(cfg, used))
    torch.cuda.synchronize()
    valid_s = time.perf_counter() - t0
    launches = counts(all_modules, all_kernels)
    missing = sorted(k for k in PATH_KERNELS["decode-planes"]
                     if k != "decoder_trunk" and launches[k] <= 0)
    bad = [k for k, v in valid.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if missing or bad or (544, 736) not in shapes:
        raise AssertionError(f"[dataset] full-resolution validation: "
                             f"kernels {missing} not launched, not "
                             f"finite {bad}, shapes {shapes}")
    log(f"[dataset] full-resolution validation from packed files "
        f"(padded shapes {shapes}): {valid_s:.2f} s; launches "
        f"{json.dumps(launches)}; {json.dumps(valid)}")
    report["full_resolution"] = {"valid_s": valid_s, "shapes": shapes,
                                 "launches": launches, "logs": valid}
    del run
    torch.cuda.empty_cache()

    # (c) card against CPU at full resolution, two cameras
    small_root = os.path.join(tmp, "small")
    write_prepared(small_root, 4, SMALL_CAMERAS, 2)
    cfg, _, _ = trainer.parse_args([
        "--dataset", "nyuv2", "--dataset-path", small_root, "--tasks",
        "semantic", "instance", "orientation", "scene",
        "--enable-panoptic", "--rgb-encoder-backbone", "resnet18",
        "--depth-encoder-backbone", "resnet18", "--input-height", "96",
        "--input-width", "128", "--fused-training", "--fused-inference",
        "--batch-size", "2",
        "--validation-batch-size", "2", "--head-decode-fusion", "auto",
        "--class-weighting", "none", "--n-workers", "4",
        "--validation-full-resolution"])
    card_run = trainer.setup(cfg, "cuda")
    for epoch in range(2):
        for i, batch in enumerate(
                card_run.data.train_loader.batches(epoch)):
            card_run.train_step(
                extract_device_batch(batch, "cuda"),
                trainer.dropout_generator_for(0, epoch, i, "cuda"))
    cpu_run = trainer.setup(cfg, "cpu")
    cpu_run.model.load_state_dict({k: v.cpu() for k, v in
                                   card_run.model.state_dict().items()})
    outs = eval_outputs_card_vs_cpu(torch, trainer, card_run, cpu_run)
    diffs = metrics_card_vs_cpu(trainer.run_validation(card_run, 0),
                                trainer.run_validation(cpu_run, 0),
                                "[dataset]")
    log(f"[dataset] R18 f32 b2, cameras {list(card_run.data.valid_loaders)}"
        f" at full resolution, card vs CPU after 4 card steps: eval "
        f"outputs {json.dumps(outs)}; largest metric difference "
        f"{max(diffs.values()):.3e} ({max(diffs, key=diffs.get)})")
    report["card_vs_cpu"] = {"outputs": outs, "metric_diffs": diffs}
    del card_run, cpu_run
    torch.set_grad_enabled(False)
    return report


# phase 7b: --remat. The flagship b8 640x480 bf16 fused_training step
# without and with remat, from one state (seed 0) at dropout 0; the
# bounds: the losses (the forward is the same) to 1e-6 relative, the
# parameters after the step within the step's own non-determinism on the
# card (the PPM's adaptive pooling and antialiased resize have no
# deterministic CUDA backward: ~1e-3 to 1e-2 max abs between two plain
# steps, ROADMAP.md), the BatchNorm running statistics to 1e-3 max abs
REMAT_LOSS_RTOL = 1e-6
REMAT_PARAM_ATOL = 2e-2
REMAT_BN_ATOL = 1e-3
REMAT_TIMED_STEPS = 5


def remat_phase(torch, card):
    """[remat]: peak memory, step ms and losses of the step without and
    with `--remat` (phase 7b); each run's launches counted from 0."""
    from emsanet_tpu_torch.bench import time_cuda
    from emsanet_tpu_torch.models import layers
    from emsanet_tpu_torch.ops import nbt1d_train as tm
    from emsanet_tpu_torch.ops import semantic_train_head as hm
    from emsanet_tpu_torch.train import dropout_generator_for

    torch.set_grad_enabled(True)
    modules = {"nbt1d_train": tm, "semantic_train_head": hm}
    t_phase = time.perf_counter()
    runs = {}
    update = layers.BatchNorm.update_running_stats
    for remat in (False, True):
        torch.cuda.empty_cache()
        model, _, step, batch, _, _ = train_setup(
            torch, 480, 640, "resnet34", 8, "bfloat16", "cuda", False,
            remat=remat)
        updates = {"first": 0, "recompute": 0}

        def counted(bn, mean, var):
            updates["recompute" if layers._RECOMPUTING[0] else "first"] += 1
            return update(bn, mean, var)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(modules, TRAIN_KERNELS)
        layers.BatchNorm.update_running_stats = counted
        try:
            metrics = step(batch, dropout_generator_for(0, 0, 0, "cuda"))
            torch.cuda.synchronize()
        finally:
            layers.BatchNorm.update_running_stats = update
        peak = torch.cuda.max_memory_allocated()
        launches = counts(modules, TRAIN_KERNELS)
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"[remat] remat={remat}: kernels {missing} "
                                 "were not launched")
        _finite_losses(metrics, f"[remat] remat={remat}")
        state = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
        step_ms = time_cuda(
            lambda: step(batch, dropout_generator_for(0, 0, 1, "cuda")), 1,
            REMAT_TIMED_STEPS)
        runs[remat] = {
            "losses": {k: float(v) for k, v in metrics.items()},
            "peak_mb": peak / 2**20, "base_mb": base / 2**20,
            "step_ms": step_ms, "launches": launches,
            "bn_updates": dict(updates), "state": state}
        log(f"[remat] remat={remat}: b8 640x480 bf16 step: peak "
            f"{peak / 2**20:.1f} MiB allocated ({base / 2**20:.1f} MiB "
            f"before the step), {step_ms:.2f} ms a step (CUDA events, "
            f"{REMAT_TIMED_STEPS} steps); running-statistics updates "
            f"{json.dumps(updates)}; launches {json.dumps(launches)}; "
            f"losses {json.dumps(runs[remat]['losses'])}")
        del model, step, batch, metrics
    plain, remat = runs[False], runs[True]
    bad = [k for k, v in plain["losses"].items()
           if abs(remat["losses"][k] - v) > REMAT_LOSS_RTOL * max(abs(v),
                                                                   1e-30)]
    params = {k: float((remat["state"][k].float()
                        - v.float()).abs().max())
              for k, v in plain["state"].items() if v.is_floating_point()}
    bn = {k: d for k, d in params.items()
          if k.endswith(("running_mean", "running_var"))}
    weights = {k: d for k, d in params.items() if k not in bn}
    worst_w = max(weights, key=weights.get)
    worst_bn = max(bn, key=bn.get)
    if (bad or weights[worst_w] > REMAT_PARAM_ATOL
            or bn[worst_bn] > REMAT_BN_ATOL
            or remat["bn_updates"]["first"] != plain["bn_updates"]["first"]
            or plain["bn_updates"]["recompute"] != 0
            or remat["bn_updates"]["recompute"] == 0):
        raise AssertionError(
            f"[remat] losses differ at {bad}; parameters max abs "
            f"{weights[worst_w]:.3g} ({worst_w}), BatchNorm statistics "
            f"{bn[worst_bn]:.3g} ({worst_bn}); updates plain "
            f"{plain['bn_updates']} remat {remat['bn_updates']}")
    report = {
        "peak_mb": {str(k): r["peak_mb"] for k, r in runs.items()},
        "step_ms": {str(k): r["step_ms"] for k, r in runs.items()},
        "losses": {str(k): r["losses"] for k, r in runs.items()},
        "launches": {str(k): r["launches"] for k, r in runs.items()},
        "bn_updates": {str(k): r["bn_updates"] for k, r in runs.items()},
        "param_max_abs": weights[worst_w], "bn_max_abs": bn[worst_bn],
        "card": card, "seconds": time.perf_counter() - t_phase}
    mem = remat["peak_mb"] / plain["peak_mb"]
    log(f"[remat] peak memory {plain['peak_mb']:.1f} -> "
        f"{remat['peak_mb']:.1f} MiB ({mem:.3f}x), "
        f"step {plain['step_ms']:.2f} -> {remat['step_ms']:.2f} ms "
        f"({remat['step_ms'] / plain['step_ms']:.3f}x); losses equal to "
        f"{REMAT_LOSS_RTOL:g}; parameters max abs {weights[worst_w]:.3g} "
        f"({worst_w}), BatchNorm statistics {bn[worst_bn]:.3g}, each "
        f"updated once ({remat['bn_updates']['first']} updates; the "
        f"recompute's {remat['bn_updates']['recompute']} BatchNorm calls "
        f"updated nothing); {card}")
    log(f"[remat] phase {report['seconds']:.1f} s")
    torch.set_grad_enabled(False)
    return report


# phase 9b: dataset preparation on the host, with the port's own readers
# and writer. A Cityscapes-layout raw set at Cityscapes' own size, and
# the synthetic set at 640x480, validated on the card
PREPARE_CITYSCAPES = (1024, 2048, 2, 1)  # height, width, train, val
PREPARE_SYNTHETIC = (2, 4, 480, 640)  # train, test, height, width
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "jpeg")


def _cityscapes_raw(root, height, width, n_train, n_val):
    """Raw Cityscapes files written with the port's PNG writer: label ids,
    instance ids (labelId * 1000 + k for things), disparity (p = 256 d +
    1); returns {(split, id): (label ids, instance ids, disparity)}."""
    import numpy as np

    from emsanet_tpu_torch.datasets.png import write_png

    rng = np.random.RandomState(0)
    written = {}
    for split, raw_split, n in (("train", "train", n_train),
                                ("valid", "val", n_val)):
        for i in range(n):
            sid = f"city_{i:06d}_000019"
            lab = rng.choice([3, 7, 11, 21, 23, 24, 26], (height, width)
                             ).astype(np.uint8)
            inst = lab.astype(np.uint16)
            box = min(64, height // 4, width // 4)
            for k in range(4):  # car and person things
                y = rng.randint(0, height - box)
                x = rng.randint(0, width - box)
                cls = (26, 24)[k % 2]
                lab[y:y + box, x:x + box] = cls
                inst[y:y + box, x:x + box] = cls * 1000 + k
            disp = rng.randint(0, 30000, (height, width)).astype(np.uint16)
            rgb = rng.randint(0, 256, (height, width, 3)).astype(np.uint8)
            for kind, suffix, arr in (
                    ("leftImg8bit", "leftImg8bit", rgb),
                    ("gtFine", "gtFine_labelIds", lab),
                    ("gtFine", "gtFine_instanceIds", inst),
                    ("disparity", "disparity", disp)):
                write_png(os.path.join(root, kind, raw_split, "city",
                                       f"{sid}_{suffix}.png"), arr)
            written[split, sid] = (rgb, lab, inst, disp)
    return written


def prepare_phase(torch, modules, tmp):
    """[prepare] (phase 9b): (a) the port's JPEG decoder equals the
    committed pixels of `tests/data/jpeg/*.jpg` (PIL's decode, as PNG);
    (b) `prepare_dataset.prepare_cityscapes` on a Cityscapes-layout raw
    set at 1024x2048 that the port writes itself, checked against the
    tool's documented mapping; (c) `prepare_synthetic` at 640x480, then
    one validation of it on the card (`train.main --validation-only`,
    the flagship R34 at full width, validation b2, decode-planes by
    'auto') with the launch counters set to 0 just before: kernels 1-8
    must launch."""
    import numpy as np

    from emsanet_tpu_torch import prepare_dataset
    from emsanet_tpu_torch import train as trainer
    from emsanet_tpu_torch.datasets.jpeg import read_jpeg
    from emsanet_tpu_torch.datasets.png import read_png

    t_phase = time.perf_counter()
    report = {}
    # (a) the JPEG fixtures
    names = sorted(f[:-4] for f in os.listdir(JPEG_FIXTURES)
                   if f.endswith(".jpg"))
    if not names:
        raise AssertionError(f"[prepare] no JPEG fixtures in {JPEG_FIXTURES}")
    for name in names:
        got = read_jpeg(os.path.join(JPEG_FIXTURES, name + ".jpg"))
        want = read_png(os.path.join(JPEG_FIXTURES, name + ".png"))
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"[prepare] JPEG fixture {name}: the "
                                 "decoder differs from PIL's pixels")
    log(f"[prepare] JPEG decoder equals PIL's pixels bit for bit on "
        f"{len(names)} fixtures: {names}")
    report["jpeg_fixtures"] = names

    # (b) Cityscapes
    raw, out = os.path.join(tmp, "cityscapes_raw"), os.path.join(
        tmp, "cityscapes")
    t0 = time.perf_counter()
    written = _cityscapes_raw(raw, *PREPARE_CITYSCAPES)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepare_dataset.prepare_cityscapes(raw, out)
    prepare_s = time.perf_counter() - t0
    lut = np.zeros(64, np.uint8)
    for k, v in prepare_dataset._CITYSCAPES_LABEL_TO_TRAIN.items():
        lut[k] = v + 1
    for (split, sid), (rgb, lab, inst, disp) in written.items():
        base = os.path.join(out, split)
        got_inst = read_png(os.path.join(base, "instance", sid + ".png"))
        things = np.where(inst >= 1000, inst, 0)
        ids = np.unique(things[things > 0])
        want_inst = np.searchsorted(ids, things) + 1
        want_inst[things == 0] = 0
        d = np.where(disp > 0, (disp.astype(np.float32) - 1) / 256, 0)
        want_depth = np.clip(np.where(
            d > 0, prepare_dataset._CITYSCAPES_BF / np.maximum(d, 1e-6), 0)
            * 100.0, 0, 65535).astype(np.uint16)
        checks = {
            "rgb": np.array_equal(read_png(os.path.join(
                base, "rgb", sid + ".png")), rgb),
            "semantic": np.array_equal(read_png(os.path.join(
                base, "semantic_19", sid + ".png")), lut[lab]),
            "instance": np.array_equal(got_inst, want_inst),
            "depth": np.array_equal(read_png(os.path.join(
                base, "depth", sid + ".png")), want_depth)}
        if not all(checks.values()):
            raise AssertionError(f"[prepare] cityscapes {split}/{sid}: "
                                 f"{checks}")
    with open(os.path.join(out, "meta.json")) as fh:
        meta = json.load(fh)
    if len(meta["semantic_labels"]) != 20:
        raise AssertionError("[prepare] cityscapes meta.json: "
                             f"{len(meta['semantic_labels'])} labels")
    h, w, n_train, n_val = PREPARE_CITYSCAPES
    log(f"[prepare] cityscapes {h}x{w}, {n_train} train + {n_val} val "
        f"frames: raw files written in {write_s:.1f} s, prepared in "
        f"{prepare_s:.1f} s (host); rgb, semantic, instance and depth "
        f"equal to the documented mapping; meta.json depth mean "
        f"{meta['depth_stats']['mean']:.1f}")
    report["cityscapes"] = {"write_s": write_s, "prepare_s": prepare_s}

    # (c) synthetic, validated on the card
    root = os.path.join(tmp, "prepared_synthetic")
    n_train, n_test, h, w = PREPARE_SYNTHETIC
    t0 = time.perf_counter()
    prepare_dataset.prepare_synthetic(root, n_train, n_test, h, w)
    report["synthetic_prepare_s"] = time.perf_counter() - t0
    argv = ["--dataset", "nyuv2", "--dataset-path", root, "--tasks",
            "semantic", "instance", "orientation", "scene",
            "--enable-panoptic", "--mixed-precision", "--fused-inference",
            "--batch-size", "2", "--validation-batch-size", "2",
            "--head-decode-fusion", "auto", "--n-workers", "4",
            "--validation-only", "--skip-sanity-check",
            "--results-basepath", os.path.join(tmp, "prepare_runs")]
    reset_counts(modules)
    t0 = time.perf_counter()
    if trainer.main(argv) != 0:
        raise AssertionError("[prepare] the validation did not end with 0")
    torch.cuda.synchronize()
    valid_s = time.perf_counter() - t0
    launches = counts(modules)
    missing = sorted(k for k, n in launches.items() if n <= 0)
    if missing:
        raise AssertionError(f"[prepare] the validation of the prepared "
                             f"set did not launch {missing}")
    (run_dir,) = os.listdir(os.path.join(tmp, "prepare_runs", "nyuv2"))
    with open(os.path.join(tmp, "prepare_runs", "nyuv2", run_dir,
                           "metrics.csv")) as fh:
        header, row = [r.split(",") for r in fh.read().strip().splitlines()]
    logs = dict(zip(header, row))
    bad = [k for k, v in logs.items() if k.startswith("valid_")
           and not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"[prepare] validation metrics not finite: "
                             f"{bad}")
    log(f"[prepare] synthetic {w}x{h} ({n_train} train, {n_test} test) "
        f"prepared in {report['synthetic_prepare_s']:.1f} s; validation "
        f"of its test split on the card (flagship R34, bf16, b2, "
        f"decode-planes): {valid_s:.1f} s with setup; launches "
        f"{json.dumps(launches)}; valid_semantic_miou "
        f"{logs.get('valid_semantic_miou')}")
    report.update(valid_s=valid_s, launches=launches,
                  seconds=time.perf_counter() - t_phase)
    log(f"[prepare] phase {report['seconds']:.1f} s")
    return report


def resume_config_phase(torch, modules, run_dir):
    """Phase 9c: `train.main(["resume", run_dir, "--n-epochs", "3"])`
    continues phase 9's 2-epoch flagship run (its recorded argv, its
    resume checkpoint) for one more epoch, with the launch counters set
    to 0 just before: kernels 1-7, 9 and 10 must launch, the new run's
    metrics.csv holds epoch 2 alone, finite; then `--config
    configs/nyuv2_multitask.json` with explicit overrides parses to the
    file's values under the flags."""
    from emsanet_tpu_torch import train as trainer
    from emsanet_tpu_torch.ops import nbt1d_train as tm
    from emsanet_tpu_torch.ops import semantic_train_head as hm

    t_phase = time.perf_counter()
    torch.set_grad_enabled(True)
    all_modules = {**modules, "nbt1d_train": tm, "semantic_train_head": hm}
    all_kernels = KERNELS + TRAIN_KERNELS
    base = os.path.dirname(run_dir)
    before = set(os.listdir(base))
    reset_counts(all_modules, all_kernels)
    if trainer.main(["resume", run_dir, "--n-epochs", "3"]) != 0:
        raise AssertionError("[resume] the resumed run did not end with 0")
    torch.cuda.synchronize()
    launches = counts(all_modules, all_kernels)
    need = (PATH_KERNELS["decode-planes"] - {"decoder_trunk"}) | {
        name for name, *_ in TRAIN_KERNELS}
    missing = sorted(k for k in need if launches[k] <= 0)
    (new,) = set(os.listdir(base)) - before
    with open(os.path.join(base, new, "metrics.csv")) as fh:
        header, *rows = [r.split(",") for r in
                         fh.read().strip().splitlines()]
    epochs = [dict(zip(header, r)) for r in rows]
    with open(os.path.join(base, new, "argsv.txt")) as fh:
        argv = fh.read()
    bad = [k for e in epochs for k, v in e.items()
           if k.startswith(("train_", "valid_"))
           and not math.isfinite(float(v))]
    if (missing or bad or [e["epoch"] for e in epochs] != ["2"]
            or "--resume-ckpt-filepath" not in argv):
        raise AssertionError(f"[resume] kernels {missing} not launched, "
                             f"epochs {[e['epoch'] for e in epochs]}, not "
                             f"finite {bad}, argv {argv}")
    log(f"[resume] resume {os.path.basename(run_dir)} --n-epochs 3: epoch "
        f"2 in a new run directory; launches {json.dumps(launches)}; "
        f"{json.dumps(epochs[0])}")
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "nyuv2_multitask.json")
    with open(config) as fh:
        file_cfg = json.load(fh)
    cfg, _, _ = trainer.parse_args(["--config", config, "--batch-size", "4",
                                    "--n-epochs", "3", "--notes", "smoke"])
    got = {"tasks": list(cfg.model.tasks),
           "rgb_encoder_backbone": cfg.model.rgb_encoder_backbone,
           "tasks_weighting": list(cfg.train.tasks_weighting),
           "validation_skip": cfg.train.validation_skip,
           "batch_size": cfg.data.batch_size,
           "n_epochs": cfg.train.n_epochs, "notes": cfg.train.notes,
           "learning_rate": cfg.train.learning_rate}
    want = {"tasks": file_cfg["model"]["tasks"],
            "rgb_encoder_backbone": file_cfg["model"]["rgb_encoder_backbone"],
            "tasks_weighting": file_cfg["train"]["tasks_weighting"],
            "validation_skip": file_cfg["train"]["validation_skip"],
            "batch_size": 4, "n_epochs": 3, "notes": "smoke",
            "learning_rate": file_cfg["train"]["learning_rate"] * 4 / 8}
    if got != want:
        raise AssertionError(f"[config] parsed {got}, expected {want}")
    log(f"[config] --config configs/nyuv2_multitask.json --batch-size 4 "
        f"--n-epochs 3 --notes smoke: {json.dumps(got)}")
    torch.set_grad_enabled(False)
    report = {"launches": launches, "epoch_2": epochs[0], "config": got,
              "seconds": time.perf_counter() - t_phase}
    log(f"[resume] phase {report['seconds']:.1f} s")
    return report


# phase 10: the inference scripts. Kinect-v2-style sample pairs (the
# second one is resized for the panel's RGB tile); the kernels each
# script's run must launch: the b1 sample path 1-5 and the trunk (8,
# 'auto' at batch 1), the b8 dataset path with 'auto' (-> decode-planes)
# 1-7
INFERENCE_SAMPLES = ((480, 640), (540, 960))
SAMPLE_KERNELS = PATH_KERNELS["decode"]
DATASET_KERNELS = PATH_KERNELS["decode-planes"] - {"decoder_trunk"}
INFERENCE_TASKS = ("--tasks", "semantic", "instance", "orientation", "scene",
                   "--enable-panoptic", "--fused-inference")
TIMING_RUNS = ("--n-runs", "10", "--n-runs-warmup", "3")
# what `--visualize-validation` writes per validation (the reference's
# folders with every task and panoptic)
VISUALIZATION_FOLDERS = {
    "semantic", "semantic_score", "instance", "instance_center",
    "instance_offset", "panoptic", "orientation", "orientations",
    "orientations_white_bg", "scene", "gt_semantic", "gt_instance",
    "gt_instance_center", "gt_panoptic", "gt_orientations",
    "gt_orientations_white_bg", "gt_depth"}


def upstream_checkpoint(torch, path):
    """The flagship's seed-0 weights (R34-NBt1D, NYUv2's 40 classes and
    scenes, f32, `weights.random_init_`) saved in the upstream layout:
    the port's names mapped back through `torch_compat/name_map.py`,
    'model.'-prefixed, the encoder under its 'fused_encoders.' alias, in
    a {'state_dict': ...} wrapper. Returns the port's state dict."""
    from emsanet_tpu_torch.config import flagship_config
    from emsanet_tpu_torch.datasets.metadata import get_dataset_config
    from emsanet_tpu_torch.models.emsanet import build_model
    from emsanet_tpu_torch.torch_compat.name_map import (
        emsanet_torch_name_map,
    )

    model = build_model(flagship_config(compute_dtype="float32"),
                        get_dataset_config("nyuv2"), device="cpu", seed=0)
    source = model.state_dict()
    upstream_name = {p: t for t, p in emsanet_torch_name_map().items()}
    upstream = {}
    for key, value in source.items():
        name = upstream_name[key]
        if name.startswith("encoder."):
            name = "fused_encoders." + name[len("encoder."):]
        upstream["model." + name] = value.contiguous()
    torch.save({"state_dict": upstream, "epoch": 0}, path)
    return source


def chain_share(rows):
    """(chain device ms, device ms of the kernels, the five longest
    kernels as 'name ms') of profiled rows; copies are left out."""
    kernels = [r for r in rows if not r[2].startswith(("Memcpy", "Memset"))]
    chain = sum(ms for ms, _, key in kernels if "nbt1d_pair" in key
                or "conv3tap" in key or "splitk_epilogue" in key)
    top = [f"{key[:48]} {ms:.3f}" for ms, _, key in kernels[:5]]
    return chain, sum(ms for ms, _, _ in kernels), top


def inference_phase(torch, modules, tmp):
    """Phase 10: the inference scripts and the checkpoint import.
    (a) An upstream-layout `.pth` of the flagship's seed-0 weights,
    imported by `python -m emsanet_tpu_torch.import_torch_checkpoint`;
    the imported tensors equal the source's bit for bit. (b) Sample
    inference of the flagship (R34-NBt1D, 640x480, NYUv2's 40 classes,
    every task, panoptic) with the imported weights on two sample pairs
    (480x640; 540x960), in f32 and with `--mixed-precision`: host ms per
    sample and step, launches (kernels 1-5 and 8 must launch), panels of
    (960, 2560, 3) uint8; one more f32 run of the first pair under
    torch.profiler for the f32 chain's share of the device time. (c)
    Dataset inference of phase 9's PNG dataset (both cameras) at b8 in
    bf16 with `--head-decode-fusion auto` (-> decode-planes), every
    format, `--inference-output-fullres`: files, seconds, host ms per
    batch; kernels 1-7 must launch; every file read back; one more f32
    run (semantic files only) under torch.profiler for the chain's share.
    (d) Both scripts with the small R18 96x128 f32 model (seeded random
    weights, `build_model`) on the card and on the CPU, on the sample
    pairs and phase 9's small dataset: outputs within
    `tests/torch_inference_cases.py`'s limits. (e) `--visualize-
    validation` for one validation of the small model: `epoch_0000`
    holds every folder the reference writes. (f) `python -m
    emsanet_tpu_torch.inference_time --sweep` (b1, b8, b32 x bf16, f32;
    3 warmup and 10 timed runs): frames/s."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_inference_cases as cases

    from emsanet_tpu_torch import inference_dataset, inference_samples
    from emsanet_tpu_torch import inference_time
    from emsanet_tpu_torch import train as trainer
    from emsanet_tpu_torch.config import flagship_config
    from emsanet_tpu_torch.datasets.metadata import get_dataset_config
    from emsanet_tpu_torch.datasets.png import read_png
    from emsanet_tpu_torch.models.emsanet import build_model
    from emsanet_tpu_torch.training.checkpoint import save_checkpoint

    report = {}
    root = os.path.join(tmp, "inference")
    t_phase = time.perf_counter()
    # (a) the upstream checkpoint through the import tool
    t0 = time.perf_counter()
    pth = os.path.join(root, "upstream", "emsanet_r34.pth")
    os.makedirs(os.path.dirname(pth))
    source = upstream_checkpoint(torch, pth)
    imported_dir = os.path.join(root, "imported")
    res = subprocess.run(
        [sys.executable, "-m", "emsanet_tpu_torch.import_torch_checkpoint",
         pth, imported_dir, "--backbone", "resnet34", "--device", "cuda"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"[inference] import_torch_checkpoint exited "
                             f"{res.returncode}: {res.stdout[-2000:]}"
                             f"{res.stderr[-2000:]}")
    imported = os.path.join(imported_dir, "imported_torch.pt")
    saved = torch.load(imported, map_location="cpu",
                       weights_only=True)["model"]
    differ = [k for k, v in source.items() if not torch.equal(saved[k], v)]
    if differ:
        raise AssertionError(f"[inference] imported tensors differ from the "
                             f"source: {differ[:5]}")
    import_s = time.perf_counter() - t0
    log(f"[inference] upstream checkpoint of the flagship's seed-0 weights "
        f"({len(source)} tensors) imported by python -m "
        f"emsanet_tpu_torch.import_torch_checkpoint in {import_s:.1f} s "
        f"(`{res.stdout.strip().splitlines()[0]}`): every tensor equal, bit "
        "for bit")
    report["import"] = {"seconds": import_s, "tensors": len(source)}
    del source, saved

    # (b) sample inference of the flagship
    samples = os.path.join(root, "samples")
    names = cases.write_samples(samples, INFERENCE_SAMPLES)
    flags = ["--device", "cuda", "--dataset", "nyuv2", *INFERENCE_TASKS,
             "--raw-depth", "--depth-max", "8000", "--weights-filepath",
             imported, "--sample-path", samples]
    report["samples"] = {}
    for label, extra in (("f32", []), ("bf16", ["--mixed-precision"])):
        out = os.path.join(root, f"panels_{label}")
        torch.cuda.synchronize()
        reset_counts(modules)
        t0 = time.perf_counter()
        runs = inference_samples.run(flags + extra + ["--output-path", out])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts(modules)
        missing = sorted(k for k in SAMPLE_KERNELS if launches[k] <= 0)
        if missing:
            raise AssertionError(f"[inference] samples {label}: kernels "
                                 f"{missing} were not launched")
        for name in names:
            cases.panel_tiles(read_png(os.path.join(out,
                                                    f"result_{name}.png")),
                              480, 640)
        log(f"[inference] samples, flagship R34 640x480 {label} b1, "
            f"{len(runs)} samples in {seconds:.2f} s (model build and "
            f"weights included); host ms per sample: " + "; ".join(
                f"{r['name']} " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in r["ms"].items())
                for r in runs)
            + f"; {runs[0]['scene']}; launches {json.dumps(launches)}")
        report["samples"][label] = {"seconds": seconds, "launches": launches,
                                    "ms": [r["ms"] for r in runs]}
    one = os.path.join(root, "one_sample")
    os.makedirs(one)
    for suffix in ("rgb", "depth"):
        shutil.copy(os.path.join(samples, f"{names[0]}_{suffix}.png"), one)
    flags_one = [f if f != samples else one for f in flags]
    wall_ms, rows = profile_frame(
        lambda _: inference_samples.run(flags_one + [
            "--output-path", os.path.join(root, "panels_profiled")]), None)
    chain_ms, kernel_ms, top = chain_share(rows)
    log(f"[inference] f32 sample (480x640) under torch.profiler: device "
        f"kernels {kernel_ms:.3f} ms, of which the chain {chain_ms:.3f} ms "
        f"({100 * chain_ms / max(kernel_ms, 1e-9):.1f}%); the run's wall "
        f"{wall_ms:.1f} ms (model build included); top kernels (ms): "
        f"{', '.join(top)}")
    report["samples"]["f32_profile"] = {"kernel_ms": kernel_ms,
                                        "chain_ms": chain_ms, "top": top}

    # (c) dataset inference over phase 9's PNG dataset
    dflags = ["--device", "cuda", "--dataset", "nyuv2", "--dataset-path",
              os.path.join(tmp, "png"), *INFERENCE_TASKS, "--raw-depth",
              "--weights-filepath", imported, "--batch-size", "8",
              "--validation-batch-size", "8", "--head-decode-fusion", "auto",
              "--n-workers", str(LOADER_WORKERS)]
    out = os.path.join(root, "dataset_bf16")
    torch.cuda.synchronize()
    reset_counts(modules)
    t0 = time.perf_counter()
    meta = inference_dataset.run(dflags + [
        "--mixed-precision", "--inference-output-path", out,
        "--inference-output-format", *inference_dataset.FORMATS,
        "--inference-output-fullres"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(modules)
    missing = sorted(k for k in DATASET_KERNELS if launches[k] <= 0)
    mode = meta["config"]["model"]["head_decode_fusion"]
    if missing or mode != "decode-planes":
        raise AssertionError(f"[inference] dataset: kernels {missing} were "
                             f"not launched (mode {mode})")
    files = cases.read_back(out)
    if files.get("semantic") != meta["n_samples"] or meta["n_samples"] != (
            len(DATASET_CAMERAS) * DATASET_VALID_PER_CAMERA):
        raise AssertionError(f"[inference] dataset: {meta['n_samples']} "
                             f"samples, files {files}")
    log(f"[inference] dataset, flagship bf16 b8 decode-planes, "
        f"{meta['n_samples']} samples of 2 cameras at full resolution, "
        f"every format: {seconds:.2f} s (model build included), files read "
        f"back {json.dumps(files)}; host ms per batch: eval step to host "
        f"{[round(1e3 * v, 1) for v in meta['batch_s']]}, writers "
        f"{[round(1e3 * v, 1) for v in meta['write_s']]}; launches "
        f"{json.dumps(launches)}")
    report["dataset"] = {"seconds": seconds, "files": files,
                         "launches": launches, "batch_s": meta["batch_s"],
                         "write_s": meta["write_s"]}
    box = {}
    wall_ms, rows = profile_frame(lambda _: box.setdefault(
        "meta", inference_dataset.run(dflags + [
            "--inference-output-path", os.path.join(root, "dataset_f32")])),
        None)
    chain_ms, kernel_ms, top = chain_share(rows)
    n_batches = len(box["meta"]["batch_s"])
    log(f"[inference] dataset f32 (semantic files) under torch.profiler: "
        f"{n_batches} b8 batches, device kernels {kernel_ms:.3f} ms, of "
        f"which the chain {chain_ms:.3f} ms "
        f"({100 * chain_ms / max(kernel_ms, 1e-9):.1f}%); host ms per batch "
        f"{[round(1e3 * v, 1) for v in box['meta']['batch_s']]} (profiled); "
        f"top kernels (ms): {', '.join(top)}")
    report["dataset"]["f32_profile"] = {
        "kernel_ms": kernel_ms, "chain_ms": chain_ms, "batches": n_batches,
        "batch_s": box["meta"]["batch_s"], "top": top}

    # (d) the small model, card against CPU
    small = os.path.join(tmp, "small")
    ckpt = os.path.join(root, "small.pt")
    save_checkpoint(ckpt, build_model(flagship_config(
        input_height=96, input_width=128, rgb_encoder_backbone="resnet18",
        depth_encoder_backbone="resnet18", compute_dtype="float32"),
        get_dataset_config("synthetic"), device="cpu", seed=0), None, 0)
    panels, trees = {}, {}
    for device in ("cuda", "cpu"):
        sflags = ["--device", device, "--dataset", "nyuv2", "--dataset-path",
                  small, *cases.SMALL_FLAGS, "--raw-depth", "--n-workers", "4",
                  "--weights-filepath", ckpt]
        panels[device] = os.path.join(root, f"small_panels_{device}")
        inference_samples.run(sflags + [
            "--sample-path", samples, "--depth-max", "8000",
            "--output-path", panels[device]])
        trees[device] = os.path.join(root, f"small_dataset_{device}")
        inference_dataset.run(sflags + [
            "--batch-size", "2", "--head-decode-fusion", "auto",
            "--inference-output-path", trees[device],
            "--inference-output-format", *inference_dataset.FORMATS,
            "--inference-output-fullres"])
    tiles = cases.compare_panels(panels["cuda"], panels["cpu"], names, 96,
                                 128)
    tree = cases.compare_dataset_outputs(trees["cuda"], trees["cpu"])
    log(f"[inference] R18 96x128 f32, card vs CPU: panel tiles (share of "
        f"pixels off by more than {cases.TILE_LEVELS} level) "
        f"{json.dumps(tiles)}; dataset outputs {json.dumps(tree)}")
    report["card_vs_cpu"] = {"tiles": tiles, "dataset": tree}

    # (e) --visualize-validation
    runs_dir = os.path.join(root, "runs")
    trainer.main(["--device", "cuda", "--dataset", "nyuv2",
                  "--dataset-path", small, *cases.SMALL_FLAGS,
                  "--batch-size", "2", "--validation-batch-size", "2",
                  "--n-workers", "4", "--validation-only",
                  "--skip-sanity-check", "--visualize-validation",
                  "--weights-filepath", ckpt, "--results-basepath",
                  runs_dir])
    (run_dir,) = os.listdir(os.path.join(runs_dir, "nyuv2"))
    epoch_dir = os.path.join(runs_dir, "nyuv2", run_dir, "examples",
                             "epoch_0000")
    folders = set(os.listdir(epoch_dir))
    if folders != VISUALIZATION_FOLDERS:
        raise AssertionError(f"[inference] --visualize-validation wrote "
                             f"{sorted(folders)}")
    n_files = sum(len(fs) for _, _, fs in os.walk(epoch_dir))
    log(f"[inference] --visualize-validation: epoch_0000 holds the "
        f"reference's {len(folders)} folders ({n_files} files)")
    report["visualize_validation"] = {"folders": len(folders),
                                      "files": n_files}

    # (f) inference_time --sweep
    rows = inference_time.run(["--device", "cuda", *INFERENCE_TASKS,
                               "--sweep", *TIMING_RUNS])
    log("[inference] inference_time --sweep (flagship 640x480, forward, "
        "3 warmup + 10 timed runs), frames/s: " + "; ".join(
            f"b{r['batch_size']} {r['dtype']} {r['fps_mean']:.2f} +- "
            f"{r['fps_std']:.2f} ({r['latency_ms']:.2f} ms, "
            f"{r['head_decode_fusion']})" for r in rows))
    report["timing"] = rows
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[inference] phase {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# 11. the other model settings

FIVE_TASKS = ("semantic", "instance", "orientation", "scene", "normal")
VARIANT_ROUNDS = 3  # frame timing: median of rounds of 5 frames
VARIANT_H, VARIANT_W = 480, 640
# (label, ModelConfig overrides, backbone, head mode) of phase 11's (b)
# and (c) models; each frame must launch the stem and the chain
ENCODER_VARIANTS = (
    ("rgbd R34", {"input_modalities": ("rgbd",)}, "resnet34"),
    ("rgb R34", {"input_modalities": ("rgb",)}, "resnet34"),
    ("R50 dual", {}, "resnet50"),
)
# (d): the CPU parity list's settings (tests/test_torch_port_variants_*.py)
# as small R18 96x128 f32 b2 frames, card against CPU
CPU_PARITY_SETTINGS = (
    ("tasks+normal", {"tasks": FIVE_TASKS}),
    ("five tasks, trunk on", {"tasks": FIVE_TASKS,
                              "decoder_megakernel": "on"}),
    ("normal only", {"tasks": ("normal",), "enable_panoptic": False}),
    ("mlp every task", {"tasks": FIVE_TASKS,
                        "semantic_decoder": "segformermlp",
                        "instance_decoder": "segformermlp",
                        "normal_decoder": "segformermlp"}),
    ("mlp mixed with dense", {"tasks": FIVE_TASKS,
                              "semantic_decoder": "segformermlp",
                              "normal_decoder": "segformermlp"}),
    ("basicblock and bottleneck blocks", {
        "tasks": ("semantic", "instance", "normal"), "enable_panoptic": False,
        "semantic_decoder_block": "basicblock",
        "normal_decoder_block": "bottleneck"}),
    ("rgb resnet18-d16", {"input_modalities": ("rgb",),
                          "rgb_encoder_backbone": "resnet18-d16",
                          "encoder_decoder_skip_downsamplings": (4, 8),
                          "semantic_decoder_n_channels": (256, 128),
                          "semantic_decoder_downsamplings": (8, 4),
                          "instance_decoder_n_channels": (256, 128),
                          "instance_decoder_downsamplings": (8, 4)}),
    ("depth resnet18se", {"input_modalities": ("depth",),
                          "depth_encoder_backbone": "resnet18se"}),
    ("rgbd add-rgbd", {"input_modalities": ("rgbd",),
                       "semantic_encoder_decoder_fusion": "add-rgbd",
                       "instance_encoder_decoder_fusion": "add-rgbd"}),
    ("dual resnet18se", {"rgb_encoder_backbone": "resnet18se",
                         "depth_encoder_backbone": "resnet18se"}),
    ("resnet50", {"rgb_encoder_backbone": "resnet50",
                  "depth_encoder_backbone": "resnet50",
                  "tasks": ("semantic", "scene"), "enable_panoptic": False}),
    ("layernorm swish", {"encoder_normalization": "layernorm",
                         "decoder_normalization": "layernorm",
                         "activation": "swish"}),
    ("groupnorm silu", {"encoder_normalization": "groupnorm",
                        "decoder_normalization": "groupnorm",
                        "activation": "silu"}),
    ("unfused", {"fused_inference": False}),
)
STEM_CASES = (4, 3, 1)  # one modality's channels: rgbd, rgb, depth


def _frame_model(torch, overrides, backbone, mode, ds_name="synthetic",
                 h=None, w=None, dtype="bfloat16", device="cuda", seed=0,
                 megakernel="auto"):
    from emsanet_tpu_torch.bench import build_flagship, make_frame

    model, cfg, ds = build_flagship(
        h or VARIANT_H, w or VARIANT_W, dtype, backbone, device, seed, mode,
        megakernel, dataset=ds_name, **overrides)
    return model, cfg, make_frame(model, cfg, ds), make_frame(
        model, cfg, ds, with_postprocessing=False)


def _timed_frames(torch, frame, batch, profiled=True):
    """(median ms per batch over VARIANT_ROUNDS rounds of 5 frames, the
    range, and, where `profiled`, device busy ms of one profiled frame)."""
    from emsanet_tpu_torch.bench import time_cuda

    rounds = [time_cuda(lambda: frame(batch), 1, 5)
              for _ in range(VARIANT_ROUNDS)]
    out = {"ms": statistics.median(rounds), "min": min(rounds),
           "max": max(rounds), "busy_ms": None}
    if profiled:
        wall, rows = profile_frame(frame, batch)
        busy = sum(r[0] for r in rows)
        out.update(profiled_wall_ms=wall, busy_ms=busy if busy > 0 else None)
    return out


def _run_frames(torch, modules, frame, batches, tag, need):
    """Each batch's frame once under Capture, with the launch counters
    from 0 just before and read just after; `need` must all launch.
    Returns (results per batch, captured calls per batch, launches)."""
    for b in batches.values():  # warm-up: lazy init, cuDNN heuristics
        frame(b)
    torch.cuda.synchronize()
    reset_counts(modules)
    results, calls = {}, {}
    for n, b in batches.items():
        with Capture(modules) as cap:
            results[n] = frame(b)
        calls[n] = cap.calls
    torch.cuda.synchronize()
    launches = counts(modules)
    missing = sorted(k for k in need if launches[k] <= 0)
    if missing:
        raise AssertionError(f"[variants] {tag}: kernels {missing} were "
                             "not launched")
    for n, res in results.items():
        bad = [k for k, v in res.items() if v.is_floating_point()
               and not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError(f"[variants] {tag} b{n}: non-finite "
                                 f"outputs {bad}")
    return results, calls, launches


def _kernel_case(torch, name, args, ops_mod, tag, repeat=False):
    """A kernel against its plain version (bf16 and f32), its times and
    bound on these inputs; with `repeat`, two bf16 calls must agree bit
    for bit."""
    from emsanet_tpu_torch.bench import time_cuda

    err, abs_err = compare(name, args, {}, ops_mod, "bf16")
    err32, _ = compare(name, to_f32(name, args), {}, ops_mod, "f32")
    kfn, pfn, _, byts, ops, odt = kernel_spec(name, args, {}, ops_mod)
    if repeat:
        first, again = _outputs(kfn()), _outputs(kfn())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"[variants] {name} {tag}: two bf16 calls "
                                 "differ")
    t_bytes, t_ops = byts / PEAK_BYTES * 1e3, ops / PEAK_OPS[odt] * 1e3
    row = {"err_bf16": err, "max_abs_err": abs_err, "err_f32": err32,
           "ms": time_cuda(kfn, 2, 10), "plain_ms": time_cuda(pfn, 2, 10),
           "device_ms": device_ms(kfn),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"[variants kernel] {name} {tag}: bf16 err {err:.2e} (max abs "
        f"{abs_err:.3e}), f32 err {err32:.2e}; ms {row['ms']:.4f}, device "
        f"{_ms(row['device_ms'])}, plain {row['plain_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']})")
    return row


def _stem_case(torch, n, c, seed):
    """One modality's stem inputs at 480x640: bf16 activations, a conv
    weight of the He scale and a random BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, VARIANT_H, VARIANT_W, c), generator=g).to(
        "cuda", torch.bfloat16)
    w = (torch.randn((64, c, 7, 7), generator=g)
         * (2.0 / (49 * c)) ** 0.5).cuda()
    bn = (torch.rand(64, generator=g).cuda() + 0.5,
          (torch.randn(64, generator=g) * 0.1).cuda(),
          (torch.randn(64, generator=g) * 0.1).cuda(),
          torch.rand(64, generator=g).cuda() + 0.5)
    return ([x.contiguous()], [w], [bn])


def variants_phase(torch, modules, ops_mod):
    """Phase 11: the models of the other settings, at 640x480 in bf16 with
    random weights from seed 0.
    (a) The five-task model (R34-NBt1D dual encoder; semantic, instance,
    orientation, scene and normal; panoptic; hypersim's dataset config):
    a b1 frame in 'decode' (the decoder trunk, 'auto': one launch over
    the three dense decoders, D = 3) and a b2 frame (the trunk again); a
    b8 frame in 'decode-planes' (kernels 1-7; 17 chain calls: 8 encoder
    tails and 3 modules of each of the three decoders); three b8
    `fused_training` train steps on synthetic batches with normals
    (kernels 9 and 10; every loss finite, the normal loss included).
    (b) The rgbd R34-NBt1D encoder (one stem of C = 4) and the rgb-only
    R34-NBt1D (C = 3), b1 and b8 frames in 'decode-planes'. (c) The R50
    dual encoder (bottleneck), b1 and b8 frames in 'decode-planes'; the
    trunk where its gate admits the R50 widths. Each model: launch counts,
    ms per frame (median of rounds), device busy of one profiled b8 frame.
    Kernel cases against the plain versions: the stem with one modality
    at C = 4, 3 and 1 (b1 and b8), the trunk with D = 3 at b1 and b2 (each
    also bit for bit on repeat), the trunk at R50 widths where it ran.
    (d) Every setting of the CPU parity list as a small R18 96x128 f32 b2
    frame, card against CPU (raw outputs within 1e-3 of each leaf's
    largest magnitude, the postprocessed id maps equal on >= 0.99 of the
    pixels, as phase 4)."""
    from emsanet_tpu_torch.bench import random_raw_inputs, time_cuda
    from emsanet_tpu_torch.ops import nbt1d_train as tm
    from emsanet_tpu_torch.ops import semantic_train_head as hm
    from emsanet_tpu_torch.train import dropout_generator_for

    t_phase = time.perf_counter()
    torch.set_grad_enabled(False)
    report = {"models": {}, "kernels": {}, "card_vs_cpu": {}}
    inputs = {b: random_raw_inputs(b, VARIANT_H, VARIANT_W, seed=b,
                                   device="cuda") for b in (1, 2, 8)}
    five = {"tasks": FIVE_TASKS}

    # (a) the five-task model
    _, _, frame1, _ = _frame_model(torch, five, "resnet34", "decode",
                                   "hypersim")
    res, calls, launches = _run_frames(
        torch, modules, frame1, {1: inputs[1], 2: inputs[2]},
        "five tasks decode", PATH_KERNELS["decode"])
    trunk_d = [int(a[2][0]["cin_w"].shape[0])
               for n in (1, 2) for a, _ in calls[n]["decoder_trunk"]]
    if trunk_d != [3, 3]:
        raise AssertionError(f"[variants] five tasks: trunk calls of D "
                             f"{trunk_d}, expected one of D = 3 at b1 and b2")
    if tuple(res[1]["normal"].shape) != (1, VARIANT_H, VARIANT_W, 3):
        raise AssertionError("[variants] five tasks: normal map of shape "
                             f"{tuple(res[1]['normal'].shape)}")
    norm = torch.linalg.vector_norm(res[1]["normal"].float(), dim=-1)
    if float((norm - 1).abs().max()) > 2e-2:
        raise AssertionError("[variants] five tasks: normals not unit")
    report["kernels"]["decoder_trunk D=3 b1"] = _kernel_case(
        torch, "decoder_trunk", calls[1]["decoder_trunk"][0][0], ops_mod,
        "D=3 b1", repeat=True)
    report["kernels"]["decoder_trunk D=3 b2"] = _kernel_case(
        torch, "decoder_trunk", calls[2]["decoder_trunk"][0][0], ops_mod,
        "D=3 b2", repeat=True)
    timed = {1: _timed_frames(torch, frame1, inputs[1])}
    del frame1, res, calls
    _, _, frame8, _ = _frame_model(torch, five, "resnet34",
                                   "decode-planes", "hypersim")
    res, calls, launches8 = _run_frames(
        torch, modules, frame8, {8: inputs[8]}, "five tasks decode-planes",
        PATH_KERNELS["decode-planes"] - {"decoder_trunk"})
    n_chain = len(calls[8]["nbt1d_chain"])
    if n_chain != 17:
        raise AssertionError(f"[variants] five tasks b8: {n_chain} chain "
                             "calls, expected 17 (8 encoder tails, 3 x 3 "
                             "decoder modules)")
    timed[8] = _timed_frames(torch, frame8, inputs[8])
    del frame8, res, calls
    torch.cuda.empty_cache()
    torch.set_grad_enabled(True)
    train_mods = {"nbt1d_train": tm, "semantic_train_head": hm}
    model, _, step, batch, _, _ = train_setup(
        torch, VARIANT_H, VARIANT_W, "resnet34", 8, "bfloat16", "cuda", True,
        tasks=FIVE_TASKS)
    reset_counts(train_mods, TRAIN_KERNELS)
    for i in range(TRAIN_STEPS):
        metrics = step(batch, dropout_generator_for(0, 0, i, "cuda"))
        _finite_losses(metrics, f"[variants] five-task step {i}")
        if "normal_total_loss" not in metrics:
            raise AssertionError("[variants] the step has no normal loss")
    torch.cuda.synchronize()
    train_launches = counts(train_mods, TRAIN_KERNELS)
    if any(n <= 0 for n in train_launches.values()):
        raise AssertionError(f"[variants] train kernels not launched: "
                             f"{train_launches}")
    step_rounds = [time_cuda(lambda: step(batch), 0, 2) for _ in range(3)]
    losses = {k: round(float(v), 5) for k, v in metrics.items()}
    del model, step, batch
    torch.set_grad_enabled(False)
    torch.cuda.empty_cache()
    report["models"]["five tasks R34"] = {
        "launches_b1_b2": launches, "launches_b8": launches8,
        "trunk_d": trunk_d, "chain_calls_b8": n_chain, "frames": timed,
        "train_launches": train_launches, "train_losses": losses,
        "step_ms": statistics.median(step_rounds),
        "step_ms_range": [min(step_rounds), max(step_rounds)]}
    log(f"[variants] five tasks R34 640x480 bf16: b1 decode "
        f"{timed[1]['ms']:.3f} ms ({timed[1]['min']:.3f}-"
        f"{timed[1]['max']:.3f}), busy {_ms(timed[1]['busy_ms'])}; b8 "
        f"decode-planes {timed[8]['ms']:.3f} ms "
        f"({timed[8]['ms'] / 8:.3f} a frame), busy "
        f"{_ms(timed[8]['busy_ms'])}; trunk D {trunk_d}; chain calls b8 "
        f"{n_chain}; launches b1+b2 {json.dumps(launches)}, b8 "
        f"{json.dumps(launches8)}; b8 train step "
        f"{statistics.median(step_rounds):.2f} ms ({min(step_rounds):.2f}-"
        f"{max(step_rounds):.2f}), launches {json.dumps(train_launches)}, "
        f"last losses {json.dumps(losses)}")

    # (b), (c) the encoders
    for label, overrides, backbone in ENCODER_VARIANTS:
        _, cfg, frame, _ = _frame_model(torch, overrides, backbone,
                                        "decode-planes")
        mods = cfg.input_modalities
        vin = {b: random_raw_inputs(b, VARIANT_H, VARIANT_W, seed=b,
                                    device="cuda", modalities=mods)
               for b in (1, 8)}
        res, calls, launches = _run_frames(
            torch, modules, frame, vin, label,
            PATH_KERNELS["decode-planes"] - {"decoder_trunk"})
        stems = [[int(x.shape[3]) for x in a[0]]
                 for n in (1, 8) for a, _ in calls[n]["fused_stems"]]
        trunk_calls = calls[1]["decoder_trunk"]
        entry = {"launches": launches, "stem_channels": stems,
                 "trunk_b1": bool(trunk_calls),
                 "frames": {b: _timed_frames(torch, frame, vin[b],
                                             profiled=b == 8)
                            for b in (1, 8)}}
        if trunk_calls:
            entry["trunk_kernel"] = _kernel_case(
                torch, "decoder_trunk", trunk_calls[0][0], ops_mod,
                f"{label} b1")
        report["models"][label] = entry
        f1, f8 = entry["frames"][1], entry["frames"][8]
        log(f"[variants] {label} 640x480 bf16 decode-planes: stems of C "
            f"{stems}; b1 {f1['ms']:.3f} ms ({f1['min']:.3f}-"
            f"{f1['max']:.3f}); b8 "
            f"{f8['ms']:.3f} ms ({f8['ms'] / 8:.3f} a frame), busy "
            f"{_ms(f8['busy_ms'])}; trunk at b1: "
            f"{'yes' if trunk_calls else 'no (its gate or the fusion)'}; "
            f"launches {json.dumps(launches)}")
        del frame, res, calls, vin
        torch.cuda.empty_cache()

    # the stem with one modality against its plain version
    for c in STEM_CASES:
        for n in (1, 8):
            report["kernels"][f"fused_stems C={c} b{n}"] = _kernel_case(
                torch, "fused_stems", _stem_case(torch, n, c, 10 * c + n),
                ops_mod, f"one modality C={c} b{n}", repeat=True)

    # (d) card against CPU, every setting of the CPU parity list
    for label, overrides in CPU_PARITY_SETTINGS:
        megakernel = overrides.get("decoder_megakernel", "auto")
        kw = {k: v for k, v in overrides.items() if k != "decoder_megakernel"}
        built = {dev: _frame_model(torch, kw, "resnet18", "decode-planes",
                                   h=96, w=128, dtype="float32",
                                   device=dev, seed=1,
                                   megakernel=megakernel)
                 for dev in ("cuda", "cpu")}
        mods = built["cuda"][1].input_modalities
        sin = {"cpu": random_raw_inputs(2, 96, 128, seed=3, device="cpu",
                                        modalities=mods)}
        sin["cuda"] = {k: v.cuda() for k, v in sin["cpu"].items()}
        raw = {dev: dict(_leaves(b[3](sin[dev])))
               for dev, b in built.items()}
        post = {dev: b[2](sin[dev]) for dev, b in built.items()}
        if sorted(raw["cuda"]) != sorted(raw["cpu"]) or (
                sorted(post["cuda"]) != sorted(post["cpu"])):
            raise AssertionError(f"[variants] {label}: output keys differ")
        worst = max(rel_err(raw["cuda"][k].cpu(), v)
                    for k, v in raw["cpu"].items())
        agree = {k: float((post["cuda"][k].cpu() == post["cpu"][k])
                          .float().mean())
                 for k in ("semantic_segmentation_idx",
                           "instance_segmentation",
                           "panoptic_segmentation_deeplab")
                 if k in post["cpu"]}
        low = {k: a for k, a in agree.items() if a < 0.99}
        if worst > 1e-3 or low:
            raise AssertionError(f"[variants] {label}: card vs CPU raw "
                                 f"error {worst:.3e}, maps below 0.99: {low}")
        report["card_vs_cpu"][label] = {"raw_rel_err": worst,
                                        "min_agree": min(agree.values(),
                                                         default=1.0)}
        del built, raw, post
    log(f"[variants] card vs CPU, R18 96x128 f32 b2, {len(CPU_PARITY_SETTINGS)}"
        f" settings: worst raw output error "
        f"{max(r['raw_rel_err'] for r in report['card_vs_cpu'].values()):.2e}"
        f", least map agreement "
        f"{min(r['min_agree'] for r in report['card_vs_cpu'].values()):.4f}")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[variants] phase {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# phase 12: data parallel; phase 13: export

PARALLEL_RANKS = 2
PARALLEL_STEPS = 3


def parallel_phase(torch, card):
    """[parallel]: the data-parallel dry run on the one card (gloo, two
    ranks) and world size 1 over NCCL (module docstring, phase 12)."""
    from emsanet_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    main = dryrun.dryrun_multichip(PARALLEL_RANKS, "cuda", 480, 640,
                                   steps=PARALLEL_STEPS)
    for rank, launched in enumerate(main["all_launches"]):
        missing = sorted(k for k, n in launched.items() if n <= 0)
        if missing:
            raise AssertionError(f"[parallel] rank {rank}: kernels "
                                 f"{missing} did not launch")
    step_ms = [1e3 * s for s in main["step_s"]]
    reduce_share = main["reduce_s"] / max(sum(main["step_s"]), 1e-9)
    log(f"[parallel] (a) {PARALLEL_RANKS} ranks on one card (gloo), flagship "
        f"R34 640x480 bf16 fused_training, global b{4 * PARALLEL_RANKS}: "
        f"launches per rank {json.dumps(main['all_launches'])}; parameters "
        f"and BatchNorm buffers bit-identical across ranks after each of "
        f"{PARALLEL_STEPS} steps and the resumed step (sha256 "
        f"{main['digests'][-1][:16]}); total loss "
        + " -> ".join(f"{l['total_loss']:.5f}" for l in main["losses"]))
    log(f"[parallel] (b) sharded validation, {PARALLEL_RANKS} ranks at b4 "
        f"against one process at b4 (the same images in the same calls): "
        f"every map equal bit for bit, logs equal: "
        f"{json.dumps(main['valid_logs'])}")
    log(f"[parallel] (c) checkpoint saved by rank 0, loaded on both ranks: "
        f"parameters, buffers and optimizer state equal to the live ones bit "
        f"for bit, the next step's losses equal; its parameters "
        f"{main['resume']['param_max_abs']:.3g} max abs from the live step's "
        f"(the backward's run-to-run spread)")
    w1 = dryrun.world1_check("cuda", 480, 640, 4 * PARALLEL_RANKS,
                             PARALLEL_STEPS)
    log(f"[parallel] (d) world size 1 over {w1['backend']}: step 1's losses "
        f"equal the plain step's bit for bit; after {PARALLEL_STEPS} steps "
        f"parameters {w1['param_diff_mesh']:.3g} max abs from the closest of "
        f"3 plain runs (the farthest two plain runs: "
        f"{w1['param_diff_plain']:.3g})")
    plain_ms = [1e3 * s for s in w1["step_s_plain"]]
    mesh1_ms = [1e3 * s for s in w1["step_s_mesh"]]
    log(f"[parallel] step wall ms (first step includes warm-up): "
        f"{PARALLEL_RANKS} ranks at b4 on one card "
        f"{', '.join(f'{v:.1f}' for v in step_ms)} (all-reduce "
        f"{100 * reduce_share:.1f}% of it, through the host); world 1 over "
        f"NCCL at b8 {', '.join(f'{v:.1f}' for v in mesh1_ms)}; one process "
        f"at b8 {', '.join(f'{v:.1f}' for v in plain_ms)}. gloo through the "
        f"host on one card says nothing of NCCL across cards. {card}")
    report = {"dryrun": {k: main[k] for k in (
                  "losses", "step_s", "reduce_s", "all_launches",
                  "valid_logs", "resume")},
              "world1": w1, "reduce_share": reduce_share,
              "seconds": time.perf_counter() - t_phase}
    log(f"[parallel] phase {report['seconds']:.1f} s")
    return report


def export_phase(torch, modules, time_cuda):
    """[export]: the flagship b1 bf16 frame through `torch.export`
    (module docstring, phase 13)."""
    from emsanet_tpu_torch import export_model
    from emsanet_tpu_torch.bench import build_flagship

    t_phase = time.perf_counter()
    model, cfg, ds = build_flagship(480, 640, "bfloat16",
                                    head_decode_fusion="decode-planes")
    frame = export_model.Frame(model, cfg, ds.classes_is_thing, True)
    x = export_model.example_inputs(1, 480, 640, "cuda", seed=0)
    reset_counts(modules)
    want = frame(*x)
    torch.cuda.synchronize()
    live = {k: n for k, n in counts(modules).items() if n > 0}
    t0 = time.perf_counter()
    with torch.enable_grad():  # export traces with autograd's view
        program = export_model.export_frame(frame, 1, 480, 640)
    export_s = time.perf_counter() - t0
    ops = export_model.custom_ops(program)
    missing = sorted(set(live) - set(ops))
    if missing:
        raise AssertionError(f"[export] the program lacks the ops of "
                             f"{missing}; it holds {ops}")
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_export_"),
                        "flagship_b1.pt2")
    try:
        t0 = time.perf_counter()
        torch.export.save(program, path)
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        loaded = torch.export.load(path).module()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    reset_counts(modules)
    got = loaded(*x)
    torch.cuda.synchronize()
    ran = {k: n for k, n in counts(modules).items() if n > 0}
    if ran != live:
        raise AssertionError(f"[export] the loaded program launched {ran}, "
                             f"the live frame {live}")
    cmp = export_model.compare_outputs(got, want)
    if cmp["failed"]:
        raise AssertionError(f"[export] the loaded program differs from the "
                             f"live frame at {cmp['failed']}")
    live_ms = time_cuda(lambda: frame(*x), 3, 10)
    loaded_ms = time_cuda(lambda: loaded(*x), 3, 10)
    report = {"ops": ops, "launches": live, "size_mb": size_mb,
              "export_s": export_s, "save_s": save_s, "load_s": load_s,
              "float_max_abs": cmp["float_max_abs"], "leaves": cmp["leaves"],
              "live_ms": live_ms, "loaded_ms": loaded_ms,
              "seconds": time.perf_counter() - t_phase}
    log(f"[export] flagship b1 bf16 decode-planes with postprocessing: "
        f"traced in {export_s:.1f} s, {size_mb:.1f} MB written in "
        f"{save_s:.1f} s, loaded in {load_s:.1f} s; ops in the graph "
        f"{json.dumps(ops)}; the loaded program launched {json.dumps(ran)} "
        f"as the live frame; {cmp['leaves']} outputs equal (integer maps bit "
        f"for bit, floats max abs {cmp['float_max_abs']:.3g}); ms per call "
        f"(10 calls, CUDA events): live frame {live_ms:.3f}, loaded program "
        f"{loaded_ms:.3f}")
    log(f"[export] phase {report['seconds']:.1f} s")
    return report


def main() -> int:
    try:
        return run()
    except Exception:  # report the failing phase, exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
