"""EMSANet and ESANet (R34-NBt1D, dual encoder) inference, plain PyTorch.

The published architecture (Seichter et al., EMSANet, IJCNN 2022,
arXiv:2207.04526; ESANet, ICRA 2021, arXiv:2011.06961), written as plain
functions of a flat parameter dict in the layout of the flax / PyTorch
state dicts the benchmark fills (`<module>.<child>.weight`, BatchNorm
`running_mean` / `running_var`). Eval mode: every BatchNorm uses its
running statistics. Tensors are NCHW float32; the caller turns TF32 off.

- inputs: raw uint8 RGB and uint16 depth in mm, NHWC; RGB standardized
  with the ImageNet statistics, depth with the dataset's;
- encoder: one ResNet-34 per modality with NonBottleneck1D blocks
  (3x1 + 1x3 factorized convs with bias), 7x7/2 stem + 3x3/2 max pool;
  after the stem and after every stage the depth branch is fused into
  the RGB branch, SE(rgb) + SE(depth);
- context: a pyramid pooling module with bins 1 and 5 on the RGB branch;
  its global branch feeds the scene head;
- decoders: three modules (512, 256, 128 channels): 3x3 conv + BN + ReLU,
  three NonBottleneck1D blocks, nearest x2 + depthwise 3x3 (zero padded),
  and the RGB skip of the matching scale through a 1x1 conv + BN, added;
  then the task head at 1/4 and two more nearest x2 + depthwise stages.

`low_precision=True` is the benchmark's control, computed in float8
e4m3 (the precision below the configurations' bfloat16), as the program
computes in bfloat16: every conv and dense layer reads its input and
weight rounded to float8 with one scale per tensor and accumulates in
float32, and the output of every conv, dense layer, BatchNorm, SE gate
and residual block, and the output maps and logits, are rounded to
float8 as well.

`calibrate_bn=True` sets every BatchNorm's running statistics to the
mean and the biased variance of its input in the batch it runs on (in
place, in the parameter dict), as training leaves them, the variance at
least VAR_FLOOR of the input's mean square (the pyramid pooling's global
branch sees one value per image, and noise frames barely differ in it):
the benchmark runs it once on a calibration batch so that the seeded
network's activations keep their scale through the depth, as a trained
network's do, instead of drifting with the seed.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_STRIDES = (1, 2, 2, 2)
PPM_BINS = (1, 5)
DECODER_SKIPS = (16, 8, 4)  # the skip each decoder module adds
FP8_MAX = 448.0  # largest finite float8 e4m3fn
VAR_FLOOR = 0.01


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one per-tensor scale (amax to the
    format's largest value), back in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


class Reference:
    """The forward of one configuration over a parameter dict."""

    def __init__(self, params: Dict[str, torch.Tensor], model: Dict,
                 depth_stats: Sequence[float], low_precision: bool = False,
                 calibrate_bn: bool = False):
        self.p = params
        self.m = model
        self.depth_mean, self.depth_std = depth_stats
        self.q = fp8_round if low_precision else (lambda t: t)
        self.calibrate_bn = calibrate_bn

    # -- layers --------------------------------------------------------

    def conv(self, x, name, stride=1, padding=0, groups=1):
        w = self.p[f"{name}.weight"]
        return self.q(F.conv2d(self.q(x), self.q(w),
                               self.p.get(f"{name}.bias"), stride, padding,
                               1, groups))

    def linear(self, x, name):
        return self.q(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                               self.p[f"{name}.bias"]))

    def bn(self, x, name):
        p = self.p
        if self.calibrate_bn:
            var = torch.maximum(x.var((0, 2, 3), unbiased=False),
                                VAR_FLOOR * (x * x).mean((0, 2, 3)))
            p[f"{name}.running_mean"].copy_(x.mean((0, 2, 3)))
            p[f"{name}.running_var"].copy_(var)
        scale = p[f"{name}.weight"] * torch.rsqrt(
            p[f"{name}.running_var"] + BN_EPS)
        shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
        return self.q(x * scale[:, None, None] + shift[:, None, None])

    def conv_bn_relu(self, x, name, padding):
        return F.relu(self.bn(self.conv(x, f"{name}.Conv_0",
                                        padding=padding),
                              f"{name}.Norm_0.BatchNorm_0"))

    def se(self, x, name):
        s = F.relu(self.linear(x.mean((2, 3)), f"{name}.Dense_0"))
        s = self.linear(s, f"{name}.Dense_1")
        return self.q(x * torch.sigmoid(s)[:, :, None, None])

    def nbt1d(self, x, name, stride):
        """NonBottleneck1D; the decoders' blocks name their residual
        branch's last norm `BatchNorm_0` (zero-init variant), the
        encoders' `Norm_1`."""
        zero_init = f"{name}.BatchNorm_0.weight" in self.p
        h = F.relu(self.conv(x, f"{name}.Conv_0", (stride, 1), (1, 0)))
        h = F.relu(self.bn(self.conv(h, f"{name}.Conv_1", (1, stride),
                                     (0, 1)), f"{name}.Norm_0.BatchNorm_0"))
        h = F.relu(self.conv(h, f"{name}.Conv_2", 1, (1, 0)))
        h = self.bn(self.conv(h, f"{name}.Conv_3", 1, (0, 1)),
                    f"{name}.BatchNorm_0" if zero_init
                    else f"{name}.Norm_1.BatchNorm_0")
        residual = x
        if f"{name}.Conv_4.weight" in self.p:
            residual = self.bn(
                self.conv(x, f"{name}.Conv_4", stride),
                f"{name}.Norm_1.BatchNorm_0" if zero_init
                else f"{name}.Norm_2.BatchNorm_0")
        return self.q(F.relu(h + residual))

    def upsample2x(self, x, name):
        """Nearest x2, then the depthwise 3x3 conv with zero padding."""
        up = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(up, f"{name}.depthwise", padding=1,
                         groups=x.shape[1])

    # -- network -------------------------------------------------------

    def inputs(self, rgb_u8, depth_u16):
        mean = torch.tensor(RGB_MEAN, device=rgb_u8.device)
        std = torch.tensor(RGB_STD, device=rgb_u8.device)
        rgb = (rgb_u8.float() / 255.0 - mean) / std
        depth = (depth_u16.to(torch.int32).float() - self.depth_mean) / (
            self.depth_std)
        return (rgb.permute(0, 3, 1, 2).contiguous(),
                depth.permute(0, 3, 1, 2).contiguous())

    def encoder(self, rgb, depth):
        blocks = STAGE_BLOCKS[self.m["backbone"]]
        feats = {}
        for mod, x in (("rgb", rgb), ("depth", depth)):
            stem = f"encoder.{mod}_stem"
            x = self.conv(x, f"{stem}.Conv_0", 2, 3)
            x = F.relu(self.bn(x, f"{stem}.Norm_0.BatchNorm_0"))
            feats[mod] = F.max_pool2d(x, 3, 2, 1)
        feats["rgb"] = (self.se(feats["rgb"], "encoder.fusion0.se_main")
                        + self.se(feats["depth"], "encoder.fusion0.se_other"))
        skips = {}
        for i, (n, s) in enumerate(zip(blocks, STAGE_STRIDES)):
            for mod in ("rgb", "depth"):
                x = feats[mod]
                for b in range(n):
                    x = self.nbt1d(x, f"encoder.{mod}_stage{i}.block{b}",
                                   s if b == 0 else 1)
                feats[mod] = x
            f = f"encoder.fusion{i + 1}"
            feats["rgb"] = (self.se(feats["rgb"], f"{f}.se_main")
                            + self.se(feats["depth"], f"{f}.se_other"))
            skips[4 * 2 ** i] = feats["rgb"]
        return feats["rgb"], skips

    def context(self, x):
        h, w = x.shape[2:]
        branches, context = [x], []
        for i, b in enumerate(PPM_BINS):
            pooled = self.conv_bn_relu(F.adaptive_avg_pool2d(x, b),
                                       f"context_module.branch{i}", 0)
            context.append(pooled)
            branches.append(F.interpolate(pooled, size=(h, w),
                                          mode="bilinear",
                                          align_corners=False))
        return (self.conv_bn_relu(torch.cat(branches, 1),
                                  "context_module.fuse", 0), context[0])

    def decoder(self, x, skips, task):
        for i, ds in enumerate(DECODER_SKIPS):
            name = f"{task}_decoder.module{i}"
            x = self.conv_bn_relu(x, f"{name}.conv_in", 1)
            for b in range(self.m["decoder_blocks"]):
                x = self.nbt1d(x, f"{name}.block{b}", 1)
            x = self.upsample2x(x, f"{name}.upsample")
            fusion = f"{name}.skip_fusion"
            skip = skips[ds]
            if f"{fusion}.proj.weight" in self.p:
                skip = self.bn(self.conv(skip, f"{fusion}.proj"),
                               f"{fusion}.Norm_0.BatchNorm_0")
            x = x + skip
        head = f"{task}_decoder"
        if task == "instance":
            h = self.conv_bn_relu(x, f"{head}.head_shared_conv", 1)
            c = h.shape[1] // 3
            x = torch.cat([self.conv(h[:, t * c:(t + 1) * c],
                                     f"{head}.head_task_conv{t}", padding=1)
                           for t in range(3)], 1)
        else:
            x = self.conv(x, f"{head}.head_conv", padding=1)
        for up in ("up0", "up1"):
            x = self.upsample2x(x, f"{head}.head_upsampling.{up}")
        if task == "instance":  # sigmoid center, tanh offset
            x = torch.cat([torch.sigmoid(x[:, :1]), torch.tanh(x[:, 1:3]),
                           x[:, 3:]], 1)
        return x

    def forward(self, rgb_u8, depth_u16) -> Dict[str, torch.Tensor]:
        """NCHW float32 maps: 'semantic' logits (N, C, H, W), 'instance'
        (N, 5, H, W): center, offset (dy, dx), orientation (sin, cos);
        'scene' logits (N, S)."""
        rgb, depth = self.inputs(rgb_u8, depth_u16)
        x, skips = self.encoder(rgb, depth)
        con, global_branch = self.context(x)
        out = {}
        for task in ("semantic", "instance"):
            if task in self.m["tasks"]:
                out[task] = self.decoder(con, skips, task)
        if "scene" in self.m["tasks"]:
            out["scene"] = self.linear(global_branch.flatten(1),
                                       "scene_decoder.head")
        return {k: self.q(v) for k, v in out.items()}
