"""`correct` of a labelling cell: the timed path's maps against the plain
reference, once the window has closed.

Every pool slot's last finished request is judged: its maps as they
reached the host and the maps of the same call still on the device.
Two kinds of number are compared.

- From the raw inputs, against the reference's float32 forward (in
  blocks of rows, TF32 off): how far below the reference's best logit
  the reference puts the class the program chose (`semantic_gap`, the
  widest gap over every pixel, in units of the std of the reference's
  logits), the program's class score against the reference's probability
  of that class (`semantic_score`, the largest difference), and the
  program's center, offset and orientation maps against the reference's
  (`center`, `offset`, `orientation_map`: per image the 99.9th
  percentile of the absolute difference, the largest over the images, in
  units of the reference map's root mean square), and the same two
  numbers of the scene head's class, taken per image over the scene
  classes (`scene_gap`, in units of the std of the reference's scene
  logits; `scene_score`).
- The discrete stages (center NMS and top-k, grouping, panoptic merge,
  orientation per instance), whose outcome flips where a rounding moves
  a center by a pixel, are followed from the program's own maps: the
  reference's postprocessing of the program's semantic classes, scores
  and instance maps must give the program's instance and panoptic maps,
  centers and instance metadata, and its orientation of every instance
  valid on both sides to within ORIENTATION_RAD (float32 sums in another
  order). `post_mismatch` is the share of those elements that differ, an
  exact comparison.

Each number is held to its limit in `checks/<workload>.json`; a number
with no limit, or a limit with no number, is not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference.emsanet import Reference
from reference import postprocess as ref_post

ROWS_PER_BLOCK = 8
QUANTILE = 0.999
ORIENTATION_RAD = 1e-3


class _Std:
    """Running std and root mean square of tensors' elements (float64
    sums)."""

    def __init__(self):
        self.n = 0
        self.s = 0.0
        self.s2 = 0.0

    def add(self, t):
        t = t.double()
        self.n += t.numel()
        self.s += float(t.sum())
        self.s2 += float((t * t).sum())

    def std(self):
        mean = self.s / self.n
        return math.sqrt(max(self.s2 / self.n - mean * mean, 1e-30))

    def rms(self):
        return math.sqrt(max(self.s2 / self.n, 1e-30))


def _maps(res: Dict) -> torch.Tensor:
    """The program's full-resolution instance maps (N, 5, H, W): its
    full-resolution outputs, or its parity planes (N, 5, 4, H/2, W/2),
    plane p * 2 + q holding pixels (2i + p, 2j + q), interleaved."""
    if "instance_head_planes" in res:
        planes = res["instance_head_planes"].float()
        n, c, _, h2, w2 = planes.shape
        return planes.reshape(n, c, 2, 2, h2, w2).permute(
            0, 1, 4, 2, 5, 3).reshape(n, c, 2 * h2, 2 * w2)
    parts = [res["instance_centers"], res["instance_offsets"],
             res["instance_orientation"]]
    return torch.cat([p.float() for p in parts], -1).permute(0, 3, 1, 2)


def numbers(params: Dict[str, torch.Tensor], config: Dict,
            slots: List[Dict], device) -> Dict[str, float]:
    """The compared numbers over `slots`: each a dict with the pool's
    'inputs' (host 'rgb', 'depth'), and the program's 'host' maps and
    'device' results of one request. The reference runs with TF32 off;
    the flags are restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _numbers(params, config, slots, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _numbers(params, config, slots, device):
    ds = config["dataset"]
    model = config["reference"]
    ref = Reference({k: v.to(device).float() for k, v in params.items()},
                    model, (ds["depth_mean"], ds["depth_std"]))
    is_thing = torch.tensor(ds["classes_is_thing"], device=device)
    gap = score = 0.0
    logit_std = _Std()
    groups = {"center": (0, 1), "offset": (1, 3), "orientation_map": (3, 5)}
    tail = {k: 0.0 for k in groups}
    rms = {k: _Std() for k in groups}
    n_bad = n_all = 0
    scene = {"logits": [], "idx": [], "score": []}
    tasks = model["tasks"]
    for slot in slots:
        got = _Got(slot, device)
        n = slot["inputs"]["rgb"].shape[0]
        for b0 in range(0, n, ROWS_PER_BLOCK):
            rows = slice(b0, min(n, b0 + ROWS_PER_BLOCK))
            with torch.no_grad():
                out = ref.forward(slot["inputs"]["rgb"][rows].to(device),
                                  slot["inputs"]["depth"][rows].to(device))
            logits = out.pop("semantic")
            idx = got("semantic_segmentation_idx")[rows].long()
            top = logits.amax(1)
            at = logits.gather(1, idx[:, None])[:, 0]
            gap = max(gap, float((top - at).amax()))
            prob = torch.exp(at - top) / torch.exp(
                logits - top[:, None]).sum(1)
            sc = got("semantic_segmentation_score")[rows].float()
            score = max(score, float((prob - sc).abs().amax()))
            logit_std.add(logits)
            del logits, prob, top, at
            if "scene" in tasks:
                scene["logits"].append(out.pop("scene"))
                scene["idx"].append(got("scene_class_idx")[rows])
                scene["score"].append(got("scene_class_score")[rows])
            if "instance" in tasks:
                ref_maps = out.pop("instance")
                maps = _maps(slot["device"])[rows].to(device)
                for key, (a, b) in groups.items():
                    d = (maps[:, a:b] - ref_maps[:, a:b]).abs()
                    q = torch.quantile(d.flatten(1), QUANTILE, dim=1)
                    tail[key] = max(tail[key], float(q.amax()))
                    rms[key].add(ref_maps[:, a:b])
                del ref_maps
                bad, total = _discrete(slot, rows, maps, is_thing, got)
                n_bad, n_all = n_bad + bad, n_all + total
            del out
    result = {"semantic_gap": gap / logit_std.std(),
              "semantic_score": score}
    if "scene" in tasks:
        result.update(_scene(*(torch.cat(scene[k]) for k in
                               ("logits", "idx", "score"))))
    if "instance" in tasks:
        for key in groups:
            result[key] = tail[key] / rms[key].rms()
        result["post_mismatch"] = n_bad / n_all
    return result


def _scene(logits, idx, score) -> Dict[str, float]:
    """`scene_gap` and `scene_score` of the program's scene classes `idx`
    and scores against the reference's scene logits (N, S)."""
    logits = logits.double()
    at = logits.gather(1, idx.long()[:, None])[:, 0]
    gap = float((logits.amax(1) - at).amax()) / float(logits.std())
    prob = torch.softmax(logits, 1).gather(1, idx.long()[:, None])[:, 0]
    return {"scene_gap": gap,
            "scene_score": float((prob - score.double()).abs().amax())}


class _Got:
    """A slot's program output by key, on the device: the host copy where
    the request brought one back, else the device result; moved once."""

    def __init__(self, slot, device):
        self.slot, self.device, self.cache = slot, device, {}

    def __call__(self, key):
        if key not in self.cache:
            t = self.slot["host"].get(key)
            t = self.slot["device"][key] if t is None else t
            self.cache[key] = t.to(self.device)
        return self.cache[key]


def _discrete(slot, rows, maps, is_thing, got):
    """(differing elements, elements) of the reference's postprocessing of
    the program's own maps in `rows`."""
    sem_idx = got("semantic_segmentation_idx")[rows]
    sem_score = got("semantic_segmentation_score")[rows]
    pairs = (("instance", "instance_segmentation"),
             ("panoptic", "panoptic_segmentation_deeplab"),
             ("centers_valid", "instance_centers_valid"),
             ("centers_score", "instance_centers_score"),
             ("meta_semantic_idx", "panoptic_instance_meta_semantic_idx"),
             ("meta_area", "panoptic_instance_meta_area"),
             ("meta_score", "panoptic_instance_meta_score"),
             ("meta_valid", "panoptic_instance_meta_valid"))
    program = {k: got(key)[rows] for k, key in pairs}
    yx = got("instance_centers_yx")[rows].long()
    orient = got("orientations_instance")[rows].float()
    bad = total = 0
    for f in range(maps.shape[0]):
        ref = ref_post.postprocess_image(
            sem_idx[f], sem_score[f].float(), maps[f], is_thing,
            parity="instance_head_planes" in slot["device"])
        for k, _ in pairs:
            a, b = ref[k], program[k][f]
            bad += int((a.to(b.dtype) != b).sum())
            total += b.numel()
        valid = ref["centers_valid"]
        bad += int((ref["centers_yx"][valid] != yx[f][valid]).sum())
        total += yx[f].numel()
        both = ref["meta_valid"] & program["meta_valid"][f].bool()
        if "orientations" in ref:
            d = (ref["orientations"] - orient[f]).abs()
            d = torch.minimum(d, 2 * math.pi - d)
            bad += int((both & (d > ORIENTATION_RAD)).sum())
            total += int(both.sum())
    return bad, total


def judge(values: Dict[str, float], limits: Dict[str, Dict]):
    """(correct, [(name, value, limit)]): every limit met, and a number
    for every limit and a limit for every number."""
    rows = []
    limits = {k: v for k, v in limits.items() if not k.startswith("_")}
    ok = bool(limits) and set(values) == set(limits)
    for name in sorted(set(values) | set(limits)):
        v = values.get(name)
        lim = limits.get(name, {}).get("limit")
        good = v is not None and lim is not None and v <= lim
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
