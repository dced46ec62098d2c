"""Dataset names, their composition and the dataset of a split.

A copy of `emsanet_tpu/datasets/registry.py`. `--dataset` takes
'name1[camA,camB]:name2' (datasets joined by ':', each with an optional
list of cameras); `--dataset-path` one path, or one per dataset joined by
':'. `get_dataset` builds each (the synthetic one in memory, every other
a `PreparedDataset` on disk) and concatenates several. ScanNet takes
`scannet_subsample` for training and `validation_scannet_subsample`
otherwise, Hypersim `hypersim_subsample` for training.
`get_dataset_config` gives the first dataset's tables: its prepared
`meta.json` where it has one (and it agrees with an explicit class
count), with the indoor-domestic scenes where asked, else the built-in
tables.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from emsanet_tpu_torch.datasets.base import (
    ConcatDataset,
    SceneAnalysisDataset,
)
from emsanet_tpu_torch.datasets.disk import PreparedDataset
from emsanet_tpu_torch.datasets.metadata import (
    INDOOR_DOMESTIC_SCENES,
    DatasetConfig,
    get_dataset_config as get_metadata_config,
    load_meta_config,
)
from emsanet_tpu_torch.datasets.synthetic import SyntheticDataset

KNOWN_DATASETS = (
    "nyuv2", "sunrgbd", "hypersim", "scannet", "cityscapes", "coco",
    "scenenetrgbd", "synthetic",
)


def parse_datasets(dataset_str: str) -> List[Dict]:
    """'name1[camA,camB]:name2' -> [{'name', 'cameras'}, ...]."""
    entries = []
    for part in dataset_str.split(":"):
        if "[" in part:
            name, rest = part.split("[", 1)
            if not rest.endswith("]"):
                raise ValueError(f"Malformed dataset spec '{part}'")
            cameras = tuple(c.strip() for c in rest[:-1].split(",")
                            if c.strip())
        else:
            name, cameras = part, None
        name = name.strip().lower()
        if name not in KNOWN_DATASETS:
            raise ValueError(f"Unknown dataset '{name}', known: "
                             f"{KNOWN_DATASETS}")
        entries.append({"name": name, "cameras": cameras})
    return entries


def derive_sample_keys(input_modalities: Sequence[str],
                       tasks: Sequence[str]) -> Tuple[str, ...]:
    """Sample keys needed for the modalities and tasks."""
    keys = ["identifier"]
    if "rgb" in input_modalities or "rgbd" in input_modalities:
        keys.append("rgb")
    if "depth" in input_modalities or "rgbd" in input_modalities:
        keys.append("depth")
    if "semantic" in tasks:
        keys.append("semantic")
    if "instance" in tasks:
        keys.append("instance")
        if "semantic" not in keys:
            keys.append("semantic")  # thing/stuff needed for targets
    if "orientation" in tasks:
        keys.append("orientations")
    if "scene" in tasks:
        keys.append("scene")
    if "normal" in tasks:
        keys.append("normal")
    return tuple(keys)


def get_dataset(data_cfg, model_cfg, split: str) -> SceneAnalysisDataset:
    """The (possibly concatenated) dataset of a split."""
    entries = parse_datasets(data_cfg.dataset)
    sample_keys = derive_sample_keys(model_cfg.input_modalities,
                                     model_cfg.tasks)
    paths = (data_cfg.dataset_path or "").split(":")
    if len(paths) == 1:
        paths = paths * len(entries)
    datasets: List[SceneAnalysisDataset] = []
    for entry, path in zip(entries, paths):
        name = entry["name"]
        if name == "synthetic":
            datasets.append(SyntheticDataset(
                split=split, sample_keys=sample_keys,
                n_samples=data_cfg.synthetic_n_samples,
                height=model_cfg.input_height, width=model_cfg.input_width,
                use_cache=data_cfg.cache_dataset))
            continue
        kwargs = {}
        if name == "scannet":
            kwargs["semantic_n_classes"] = data_cfg.scannet_semantic_n_classes
            kwargs["subsample"] = (data_cfg.scannet_subsample
                                   if split == "train"
                                   else data_cfg.validation_scannet_subsample)
        if name == "hypersim" and split == "train":
            kwargs["subsample"] = data_cfg.hypersim_subsample
        datasets.append(PreparedDataset(
            dataset_path=path, dataset_name=name, split=split,
            sample_keys=sample_keys,
            depth_mode="raw" if data_cfg.raw_depth else "refined",
            use_cache=data_cfg.cache_dataset, cameras=entry["cameras"],
            scene_use_indoor_domestic_labels=(
                data_cfg.scene_use_indoor_domestic_labels),
            **kwargs))
    return datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)


def get_dataset_config(data_cfg) -> DatasetConfig:
    """The first dataset's tables (see the module's docstring)."""
    main = parse_datasets(data_cfg.dataset)[0]["name"]
    n_classes = (data_cfg.scannet_semantic_n_classes if main == "scannet"
                 else None)
    main_path = (data_cfg.dataset_path or "").split(":")[0]
    if main_path:
        meta = load_meta_config(
            main_path, depth_mode="raw" if data_cfg.raw_depth else "refined")
        if meta is not None and (
                n_classes is None
                or meta.n_semantic_classes_without_void == n_classes):
            if data_cfg.scene_use_indoor_domestic_labels and (
                    meta.scene_class_names[1:] != INDOOR_DOMESTIC_SCENES):
                meta = meta.with_scenes(INDOOR_DOMESTIC_SCENES)
            return meta
    return get_metadata_config(
        main, semantic_n_classes=n_classes,
        scene_use_indoor_domestic_labels=(
            data_cfg.scene_use_indoor_domestic_labels))
