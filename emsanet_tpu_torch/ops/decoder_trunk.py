"""Every dense decoder's trunk in one call (the decoder megakernel).

Counterpart of `emsanet_tpu/ops/decoder_trunk.py::decoder_trunk`. The
trunk of a dense decoder is, per module, conv_in 3x3 + BN + ReLU, K
stride-1 NonBottleneck1D blocks, the learned-3x3-zeropad x2 upsample and
the encoder skip's 1x1 projection + BN + add. `decoder_trunk` computes it
for D decoders at once: on a CUDA tensor in ONE launch of the
hand-written kernel `csrc/decoder_trunk.cu`, on a CPU tensor through
`decoder_trunk_plain`. Both round to the compute dtype where the TPU
kernel does (`_trunk_kernel`), not where the unfused decoder does.

`stack_trunk_params` lays the decoders' parameters out for it, one dict
per module, every tensor with a leading decoder axis D: cin_w (D, 3, 3,
C_in, C), proj_w (D, C_s, C) and the blocks' blk_w31 / blk_w13 (D, K, 2,
3, C, C) in the compute dtype; cin_s / cin_t / proj_s / proj_t (D, C)
(folded BatchNorms) and blk_b31 / blk_b13 / blk_bn_scale / blk_bn_shift
(D, K, 2, C) in float32; ups (D, 4, 4, C) float32, the four non-zero
taps of each parity of the x2 upsample (`ops/polyphase_upsample.py::
parity_taps`; the reference's (D, 2, 2, 3, 3, C) table without its zero
taps). Feature maps are NHWC.

In bf16 the kernel splits the K loop of a phase whose work items would
leave blocks of its grid idle (`trunk_plan`); `decoder_trunk_phase_ns`
runs the same launch with per-phase %globaltimer stamps.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from emsanet_tpu_torch.models.layers import stack_chain_params
from emsanet_tpu_torch.ops import _native
from emsanet_tpu_torch.ops.polyphase_upsample import parity_taps
from emsanet_tpu_torch.ops.stem import fold_bn

# The reference's batch gate for decoder_megakernel='auto', copied as it
# stands: measured on a TPU v5e (its kernel streams the weights once per
# image: b1 end to end +2.3 %, b8 -4.3 %). chip_smoke.py measures the
# trunk on and off on the H100 (PERF.md).
MAX_BATCH = 2
MAX_MODULES = 4  # csrc/decoder_trunk.cu: kMaxModules
_CHANNEL_TILE = 64  # output channels of one work item of the kernel
_PIXEL_TILE = 64  # pixels of one work item
K_STEP = 64  # input channels of one K step of the bf16 kernel
# a split of a phase's K loop runs at least this many K steps: below it
# the split's fixed cost (its first loads, its partial tile) outweighs
# what a shorter K loop saves
MIN_SPLIT_STEPS = 4

Module = Dict[str, torch.Tensor]


def trunk_supported(n: int, h0: int, w0: int, n_channels: Sequence[int],
                    c_context: int, skip_channels: Sequence[int],
                    n_blocks: int, max_batch: int | None = None) -> bool:
    """Whether `decoder_trunk` takes this trunk: batch at most MAX_BATCH
    (or `max_batch`), the reference's structural checks (as many skips as
    modules, at least one block, maps at least 2 rows high), and the
    kernel's limits: every module's C a multiple of 64, the context's and
    the skips' channels multiples of 8 (16-byte rows of bf16), at most
    MAX_MODULES modules. The TPU's tiling conditions (8-aligned widths,
    128-lane channels) do not apply to the card."""
    if n > (MAX_BATCH if max_batch is None else max_batch):
        return False
    if len(n_channels) != len(skip_channels) or not (
            1 <= len(n_channels) <= MAX_MODULES):
        return False
    if n_blocks < 1 or h0 < 2 or w0 < 1 or c_context % 8:
        return False
    return all(c % _CHANNEL_TILE == 0 and cs % 8 == 0
               for c, cs in zip(n_channels, skip_channels))


def stack_trunk_params(decoders: Sequence[torch.nn.Module],
                       dtype: torch.dtype) -> List[Module]:
    """The trunks of D `DenseDecoder`s (models/decoder.py), stacked per
    module with a leading decoder axis (layout in the module docstring).
    The parity taps are summed in a fixed order in float32
    (`polyphase_kernels`), never by an einsum."""
    per_module = []
    for i in range(decoders[0].n_modules):
        mods = [getattr(dec, f"module{i}") for dec in decoders]
        chains = [stack_chain_params(
            [getattr(m, f"block{k}") for k in range(m.n_blocks)], dtype)
            for m in mods]
        cin = [fold_bn(*m.conv_in.Norm_0.BatchNorm_0.params()) for m in mods]
        proj = [fold_bn(*m.skip_fusion.Norm_0.BatchNorm_0.params())
                for m in mods]
        entry = {
            "cin_w": torch.stack([m.conv_in.Conv_0.weight.permute(2, 3, 1, 0)
                                  for m in mods]).to(dtype),
            "cin_s": torch.stack([s for s, _ in cin]),
            "cin_t": torch.stack([t for _, t in cin]),
            **{f"blk_{k}": torch.stack([ch[k] for ch in chains])
               for k in chains[0]},
            "ups": torch.stack([parity_taps(m.upsample.depthwise.weight,
                                            torch.float32) for m in mods]),
            "proj_w": torch.stack([m.skip_fusion.proj.weight[:, :, 0, 0].t()
                                   for m in mods]).to(dtype),
            "proj_s": torch.stack([s for s, _ in proj]),
            "proj_t": torch.stack([t for _, t in proj]),
        }
        per_module.append({k: v.detach().contiguous()
                           for k, v in entry.items()})
    return per_module


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def _vec(v: torch.Tensor) -> torch.Tensor:
    return v.float()[None, :, None, None]


def _upsample(x: torch.Tensor, taps: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """x2 upsample of x (N, C, H, W) in polyphase form: each parity plane
    summed over its 4 taps (4, 4, C) in order, in f32, then rounded."""
    n, c, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    planes = []
    for p in range(4):
        pr, pc = divmod(p, 2)
        acc = None
        for t in range(4):
            a, b = divmod(t, 2)
            tap = xp[:, :, pr + a:pr + a + h, pc + b:pc + b + w] * _vec(
                taps[p, t])
            acc = tap if acc is None else acc + tap
        planes.append(_round(acc, dtype))
    # channel c * 4 + parity: F.pixel_shuffle's layout
    return F.pixel_shuffle(torch.stack(planes, 2).reshape(n, 4 * c, h, w), 2)


def decoder_trunk_plain(con_out: torch.Tensor, skips: Sequence[torch.Tensor],
                        per_module: Sequence[Module]) -> torch.Tensor:
    """Plain PyTorch, module by module: every conv an f32 `F.conv2d` of
    operands in the compute dtype (exact products, f32 sums, as the
    kernel's), rounded to the compute dtype where the kernel rounds."""
    dt = con_out.dtype
    outs = []
    for d in range(per_module[0]["cin_w"].shape[0]):
        x = con_out.permute(0, 3, 1, 2).float()
        for skip, m in zip(skips, per_module):
            w = m["cin_w"][d].to(dt).float().permute(3, 2, 0, 1)
            x = _round(F.relu(F.conv2d(x, w, padding=1) * _vec(m["cin_s"][d])
                              + _vec(m["cin_t"][d])), dt)
            for k in range(m["blk_w31"].shape[1]):
                src = x
                for half in range(2):
                    w31 = m["blk_w31"][d, k, half].to(dt).float()
                    w13 = m["blk_w13"][d, k, half].to(dt).float()
                    z = _round(F.relu(F.conv2d(
                        src, w31.permute(2, 1, 0)[..., None],
                        m["blk_b31"][d, k, half].float(), padding=(1, 0))),
                        dt)
                    z = F.conv2d(z, w13.permute(2, 1, 0)[:, :, None],
                                 m["blk_b13"][d, k, half].float(),
                                 padding=(0, 1))
                    z = (z * _vec(m["blk_bn_scale"][d, k, half])
                         + _vec(m["blk_bn_shift"][d, k, half]))
                    if half == 0:
                        src = _round(F.relu(z), dt)
                    else:
                        x = _round(F.relu(z + x), dt)
            up = _upsample(x, m["ups"][d], dt)
            pw = m["proj_w"][d].to(dt).float().t()[:, :, None, None]
            proj = _round(F.conv2d(skip.permute(0, 3, 1, 2).float(), pw)
                          * _vec(m["proj_s"][d]) + _vec(m["proj_t"][d]), dt)
            x = _round(up + proj, dt)
        outs.append(x.permute(0, 2, 3, 1))
    return torch.stack(outs).to(dt).contiguous()


@dataclass(frozen=True)
class TrunkPhase:
    """One phase of the kernel: its work items (decoder, 64 pixels, 64
    output channels), K steps (64 input channels of one tap) and the
    number of splits of its K loop."""
    name: str
    items: int
    steps: int
    split: int

    def split_steps(self, s: int) -> Tuple[int, int]:
        """The K steps [lo, hi) of split s, as the kernel takes them."""
        return (s * self.steps // self.split,
                (s + 1) * self.steps // self.split)


def _split(items: int, steps: int, grid: int) -> int:
    """The K split of a phase: items x split fills the grid in one wave,
    each split keeping at least MIN_SPLIT_STEPS steps (or the whole K
    loop); a phase with at least as many items as blocks is not split."""
    if items >= grid:
        return 1
    return max(1, min(grid // items, steps // MIN_SPLIT_STEPS))


@functools.lru_cache(maxsize=64)
def _cached_plan(*args) -> Tuple[TrunkPhase, ...]:
    return tuple(trunk_plan(*args))


def trunk_plan(n_dec: int, n: int, h0: int, w0: int, c_context: int,
               n_channels: Sequence[int], skip_channels: Sequence[int],
               n_blocks: int, grid: int) -> List[TrunkPhase]:
    """The kernel's phases in order, with the K split of each for a grid
    of `grid` blocks: per module conv_in, the 4 n_blocks convs of the
    NBt1D blocks (all with one split) and the projection + upsample."""
    phases = []
    h, w, c_in = h0, w0, c_context
    for i, (c, cs) in enumerate(zip(n_channels, skip_channels)):
        items = n_dec * -(-n * h * w // _PIXEL_TILE) * (c // _CHANNEL_TILE)
        items2 = n_dec * -(-n * 4 * h * w // _PIXEL_TILE) * (
            c // _CHANNEL_TILE)
        blk_steps = 3 * -(-c // K_STEP)
        phases.append(TrunkPhase(f"m{i} conv_in", items,
                                 9 * -(-c_in // K_STEP), 0))
        for k in range(n_blocks):
            for half in range(2):
                for conv in ("3x1", "1x3"):
                    phases.append(TrunkPhase(f"m{i} b{k}.{half} {conv}",
                                             items, blk_steps, 0))
        phases.append(TrunkPhase(f"m{i} proj+up", items2,
                                 -(-cs // K_STEP), 0))
        h, w, c_in = 2 * h, 2 * w, c
    return [TrunkPhase(p.name, p.items, p.steps,
                       _split(p.items, p.steps, grid)) for p in phases]


def plan_workspace(phases: Sequence[TrunkPhase]) -> Tuple[int, int]:
    """(f32 partials, tickets) the split phases need: one 64 x 64 partial
    tile per unit of the largest split phase, one ticket per item."""
    split = [p for p in phases if p.split > 1]
    return (max([p.items * p.split * _PIXEL_TILE * _CHANNEL_TILE
                 for p in split] or [0]),
            max([p.items for p in split] or [0]))


_GRID: Dict[Tuple[int, bool], int] = {}
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _grid_blocks(device: torch.device, bf16: bool) -> int:
    """Blocks of the kernel's cooperative grid on `device` (the kernel's
    own count: as many as fit on the card at once)."""
    key = (device.index or 0, bf16)
    if key not in _GRID:
        fn = _native.bind("decoder_trunk", "decoder_trunk_grid", 1,
                          int_args=[0])
        with torch.cuda.device(device):
            blocks = fn(int(bf16))
        if blocks <= 0:
            _native.check(-blocks, "decoder_trunk (occupancy)")
        _GRID[key] = blocks
    return _GRID[key]


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The split phases' tickets for the current stream of `device`:
    zeroed once; each launch leaves them at zero again."""
    key = (device.index or 0, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


_WEIGHT_KEYS = ("cin_w", "blk_w31", "blk_w13", "proj_w")
# every tensor of a module's entry, in the order of the kernel's fields
_FIELD_KEYS = ("cin_w", "cin_s", "cin_t", "blk_w31", "blk_w13", "blk_b31",
               "blk_b13", "blk_bn_scale", "blk_bn_shift", "ups")


def _check_module(i: int, m: Module, dt: torch.dtype, d: int, k: int,
                  c_in: int, c: int, cs: int) -> None:
    shapes = {
        "cin_w": (d, 3, 3, c_in, c), "cin_s": (d, c), "cin_t": (d, c),
        "blk_w31": (d, k, 2, 3, c, c), "blk_w13": (d, k, 2, 3, c, c),
        "blk_b31": (d, k, 2, c), "blk_b13": (d, k, 2, c),
        "blk_bn_scale": (d, k, 2, c), "blk_bn_shift": (d, k, 2, c),
        "ups": (d, 4, 4, c), "proj_w": (d, cs, c), "proj_s": (d, c),
        "proj_t": (d, c),
    }
    for key, shape in shapes.items():
        t = m[key]
        want = dt if key in _WEIGHT_KEYS else torch.float32
        _native.require_cuda_tensor(t, f"module {i} {key}", (want,),
                                    len(shape))
        if tuple(t.shape) != shape or t.device != m["cin_w"].device:
            raise ValueError(f"decoder_trunk: module {i} {key} has shape "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shape}")
        if t.data_ptr() % 16:
            raise ValueError(f"decoder_trunk: module {i} {key} must be "
                             "16-byte aligned")


def decoder_trunk(con_out: torch.Tensor, skips: Sequence[torch.Tensor],
                  per_module: Sequence[Module]) -> torch.Tensor:
    """The trunks of D decoders: con_out (N, H0, W0, C0) the context
    module's output, skips[i] (N, 2^(i+1) H0, 2^(i+1) W0, C_s) module i's
    encoder skip, per_module from `stack_trunk_params`. Returns (D, N,
    2^M H0, 2^M W0, C_last), each decoder's head input."""
    if not con_out.is_cuda:
        return decoder_trunk_plain(con_out, skips, per_module)
    return _launch(con_out, skips, per_module, None)[0]


# %globaltimer stamps per phase (csrc/decoder_trunk.cu kStampRow): its
# start, the last block's end of work, then block 0's first unit
STAMP_ROW = 8
UNIT_STEPS = ("loads issued", "first stage", "K loop", "ticket",
              "partials added", "epilogue")


def decoder_trunk_phase_ns(con_out: torch.Tensor,
                           skips: Sequence[torch.Tensor],
                           per_module: Sequence[Module]):
    """One launch of the kernel with phase stamps (CUDA tensors only):
    returns (output, one dict per phase). A phase's `work` runs from its
    start (after the previous grid barrier) until its last block finished
    its units, its `wait` until the next phase started; `unit` gives the
    times (from the phase's start) at which block 0 passed the steps of
    UNIT_STEPS in its first unit of a bf16 phase, None where it did not
    (a split that drew no last ticket, a block without a unit). All in
    nanoseconds."""
    n_phases = len(per_module) * (2 + 4 * per_module[0]["blk_w31"].shape[1])
    stamps = torch.zeros(STAMP_ROW * n_phases + 1, dtype=torch.int64,
                         device=con_out.device)
    out, phases = _launch(con_out, skips, per_module, stamps)
    st = stamps.tolist()
    rows = []
    for i, p in enumerate(phases):
        row = st[STAMP_ROW * i:STAMP_ROW * (i + 1)]
        rows.append({
            "phase": p.name, "work": row[1] - row[0],
            "wait": st[STAMP_ROW * (i + 1)] - row[1],
            "unit": [v - row[0] if v else None for v in row[2:]]})
    return out, rows


def _launch(con_out, skips, per_module, stamps: Optional[torch.Tensor]):
    """Checks, plans and launches the kernel; (output, phases)."""
    dtypes = (torch.float32, torch.bfloat16)
    _native.require_cuda_tensor(con_out, "con_out", dtypes, 4)
    dt = con_out.dtype
    n, h, w, c_in = con_out.shape
    d, k = per_module[0]["blk_w31"].shape[:2]
    if len(skips) != len(per_module) or not (
            1 <= len(per_module) <= MAX_MODULES):
        raise ValueError(f"decoder_trunk takes 1 to {MAX_MODULES} modules "
                         "and one skip per module")
    geoms = []
    for i, (skip, m) in enumerate(zip(skips, per_module)):
        c = m["cin_w"].shape[-1]
        _native.require_cuda_tensor(skip, f"skips[{i}]", (dt,), 4)
        cs = skip.shape[-1]
        if tuple(skip.shape[:3]) != (n, 2 * h, 2 * w):
            raise ValueError(f"decoder_trunk: skips[{i}] has shape "
                             f"{tuple(skip.shape)}, expected "
                             f"({n}, {2 * h}, {2 * w}, C)")
        if c % _CHANNEL_TILE or c_in % 8 or cs % 8 or h < 2:
            raise ValueError(f"decoder_trunk: module {i} takes C a multiple "
                             f"of 64, C_in and C_s multiples of 8 and at "
                             f"least 2 rows; got C {c}, C_in {c_in}, C_s "
                             f"{cs}, {h} rows")
        _check_module(i, m, dt, d, k, c_in, c, cs)
        geoms.append((h, w, c_in, c, cs))
        h, w, c_in = 2 * h, 2 * w, c
    for t in (con_out, *skips):
        if t.device != per_module[0]["cin_w"].device or t.data_ptr() % 16:
            raise ValueError("decoder_trunk: every tensor must be on one "
                             "device and 16-byte aligned")
    out = torch.empty((d, n, h, w, c_in), dtype=dt, device=con_out.device)
    map_size = d * max(n * gh * gw * gc for gh, gw, _, gc, _ in geoms)
    scratch = torch.empty((3, map_size), dtype=dt, device=con_out.device)
    mid = torch.empty(d * max([n * 4 * gh * gw * gc
                               for gh, gw, _, gc, _ in geoms[:-1]] or [0]),
                      dtype=dt, device=con_out.device)
    bf16 = dt == torch.bfloat16
    g0 = geoms[0]
    phases = _cached_plan(d, n, g0[0], g0[1], g0[2],
                          tuple(g[3] for g in geoms),
                          tuple(g[4] for g in geoms), k,
                          _grid_blocks(con_out.device, bf16) if bf16 else 1)
    ws_floats, n_tickets = plan_workspace(phases)
    ws = torch.empty(max(ws_floats, 1), dtype=torch.float32,
                     device=con_out.device)
    tickets = _tickets(con_out.device, n_tickets)
    args = [d, n, k, len(geoms), con_out.data_ptr(),
            *(scratch[j].data_ptr() for j in range(3)), ws.data_ptr(),
            tickets.data_ptr(), 0 if stamps is None else stamps.data_ptr()]
    per = 2 + 4 * k  # phases per module
    for i, ((gh, gw, gc_in, gc, gcs), m) in enumerate(zip(geoms,
                                                           per_module)):
        args += [gh, gw, gc_in, gc, gcs,
                 *(phases[per * i + j].split for j in (0, 1, per - 1)),
                 *(m[key].data_ptr() for key in _FIELD_KEYS),
                 skips[i].data_ptr(), m["proj_w"].data_ptr(),
                 m["proj_s"].data_ptr(), m["proj_t"].data_ptr(),
                 out.data_ptr() if i == len(geoms) - 1 else mid.data_ptr()]
    packed = (ctypes.c_longlong * len(args))(*args)
    fn = _native.bind("decoder_trunk", "decoder_trunk_launch", 3,
                      int_args=[0])
    err = fn(int(bf16), ctypes.addressof(packed),
             _native.stream_ptr(con_out))
    _DECODER_TRUNK.launches += 1
    _native.check(err, "decoder_trunk")
    return out, phases


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_DECODER_TRUNK = decoder_trunk
_DECODER_TRUNK.launches = 0
