"""The control and the planted faults that `correct` has to catch.

- The control: the plain reference put in the program's place, its convs
  and dense layers in float8 e4m3 (the precision below the
  configurations' bfloat16), its outputs in the program's keys and
  layouts, postprocessed by the reference.
- `half_batch`: the frame runs on the first half of each batch and the
  second half's maps repeat the first half's.
- `altered`: the frame's answers altered where they are produced: the
  first image's semantic classes and scene class move to a neighbouring
  class (one down, class 0 one up), and its instance ids to the next id.
- `scene_altered`: the first image's scene class alone moves so (cells
  with a scene head), which only the scene numbers can see.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import postprocess as ref_post
from reference.emsanet import Reference


def control_outputs(params: Dict[str, torch.Tensor], config: Dict,
                    inputs: Dict[str, torch.Tensor], device,
                    rows: int = 8) -> Dict[str, torch.Tensor]:
    """The control's results for one batch of raw inputs."""
    ds = config["dataset"]
    model = config["reference"]
    ref = Reference({k: v.to(device).float() for k, v in params.items()},
                    model, (ds["depth_mean"], ds["depth_std"]),
                    low_precision=True)
    is_thing = torch.tensor(ds["classes_is_thing"], device=device)
    parts = []
    n = inputs["rgb"].shape[0]
    for b0 in range(0, n, rows):
        sl = slice(b0, min(n, b0 + rows))
        with torch.no_grad():
            out = ref.forward(inputs["rgb"][sl].to(device),
                              inputs["depth"][sl].to(device))
        res = {}
        idx, score = ref_post.semantic_decode(out["semantic"])
        res["semantic_segmentation_idx"] = idx
        res["semantic_segmentation_score"] = score
        if "scene" in out:
            probs = torch.softmax(out["scene"], 1)
            res["scene_class_idx"] = probs.argmax(1).to(torch.int32)
            res["scene_class_score"] = probs.amax(1)
        if "instance" in out:
            maps = out["instance"]
            nhwc = maps.permute(0, 2, 3, 1)
            res["instance_centers"] = nhwc[..., 0:1]
            res["instance_offsets"] = nhwc[..., 1:3]
            res["instance_orientation"] = nhwc[..., 3:5]
            per = [ref_post.postprocess_image(idx[f], score[f], maps[f],
                                              is_thing)
                   for f in range(maps.shape[0])]
            for key, k in (("instance_segmentation", "instance"),
                           ("panoptic_segmentation_deeplab", "panoptic"),
                           ("instance_centers_yx", "centers_yx"),
                           ("instance_centers_score", "centers_score"),
                           ("instance_centers_valid", "centers_valid"),
                           ("panoptic_instance_meta_semantic_idx",
                            "meta_semantic_idx"),
                           ("panoptic_instance_meta_area", "meta_area"),
                           ("panoptic_instance_meta_score", "meta_score"),
                           ("panoptic_instance_meta_valid", "meta_valid"),
                           ("orientations_instance", "orientations")):
                res[key] = torch.stack([p[k] for p in per])
        parts.append(res)
        del out
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def half_batch(frame):
    def run(batch):
        n = next(iter(batch.values())).shape[0]
        res = frame({k: v[:n // 2] for k, v in batch.items()})
        return {k: torch.cat([v, v]) if torch.is_tensor(v)
                and v.shape[:1] == (n // 2,) else v for k, v in res.items()}
    return run


def _move_first(res, key):
    """The first image's classes under `key` to a neighbouring class."""
    if key in res:
        idx = res[key].clone()
        idx[0] = torch.where(idx[0] > 0, idx[0] - 1, idx[0] + 1)
        res[key] = idx


def altered(frame):
    def run(batch):
        res = dict(frame(batch))
        _move_first(res, "semantic_segmentation_idx")
        if "instance_segmentation" in res:
            inst = res["instance_segmentation"].clone()
            inst[0] = torch.where(inst[0] > 0, inst[0] % 64 + 1, 0)
            res["instance_segmentation"] = inst
        _move_first(res, "scene_class_idx")
        return res
    return run


def scene_altered(frame):
    def run(batch):
        res = dict(frame(batch))
        _move_first(res, "scene_class_idx")
        return res
    return run


FAULTS = {"half_batch": half_batch, "altered": altered,
          "scene_altered": scene_altered}


def faults_for(config: Dict) -> Dict:
    """The planted faults that a configuration's outputs can show."""
    tasks = config["reference"]["tasks"]
    return {k: f for k, f in FAULTS.items()
            if k != "scene_altered" or "scene" in tasks}
