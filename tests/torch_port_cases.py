"""Whole-model forward parity, the port against the JAX package, for
one configuration: the helper of the `tests/test_torch_port_configs_*.py`
files (not collected by pytest).

Both packages get the same weights and the same inputs, made with numpy:
kernels N(0, 1 / fan_in), other parameters N(0, 0.1^2), BatchNorm scales
U(0.5, 1.5), shifts and running means N(0, 0.1^2), running variances
U(0.5, 1.5), carried to the port by its own converter
(`emsanet_tpu_torch/weights.py::load_flax_variables`). Both run at f32 on
the CPU, where the port's kernel wrappers take their plain versions;
every output leaf must agree to atol 1e-4 + rtol 1e-3 (conv accumulation
order differs between XLA and PyTorch). `port_overrides` apply to the
port's configuration only (e.g. the decoder trunk 'on' against the JAX
model's own decoders, the same function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from emsanet_tpu import DataConfig, EMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu_torch import config as port_config
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.emsanet import build_model
from emsanet_tpu_torch.weights import load_flax_variables

ATOL, RTOL = 1e-4, 1e-3
TASKS = ("semantic", "instance", "orientation", "scene")


def random_variables(shapes, seed):
    """numpy-seeded variables for a flax tree of shapes."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if any(n.startswith("BatchNorm") for n in names) and names[-1] in (
                "scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def forward_parity(overrides, height=96, width=128, batch=2, seed=0,
                   port_overrides=None):
    """Run one configuration through both packages; return the worst
    (abs error, path) and assert every leaf within the tolerance. The
    port runs on one intra-op thread: an idle pool's threads would spin
    beside the JAX compiles of the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _forward_parity(overrides, height, width, batch, seed,
                               port_overrides or {})
    finally:
        torch.set_num_threads(threads)


def _forward_parity(overrides, height, width, batch, seed, port_overrides):
    model_kw = dict(tasks=TASKS, enable_panoptic=True, input_height=height,
                    input_width=width, rgb_encoder_backbone="resnet18",
                    depth_encoder_backbone="resnet18", fused_inference=True,
                    decoder_megakernel="off")
    model_kw.update(overrides)
    jcfg = EMSANetConfig(model=JaxModelConfig(**model_kw),
                         data=DataConfig(dataset="synthetic")).validate()
    jmodel = JaxEMSANet(cfg=jcfg.model,
                        dataset_config=jax_ds_config(jcfg.data))
    dummy = {"rgb": jnp.zeros((1, height, width, 3)),
             "depth": jnp.zeros((1, height, width, 1))}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), dummy)
    variables = random_variables(dict(shapes), seed + 1)

    pcfg = port_config.flagship_config(**{**model_kw, **port_overrides})
    pmodel = build_model(pcfg, get_dataset_config("synthetic"), device="cpu",
                         seed=None)
    load_flax_variables(pmodel, variables)

    rng = np.random.RandomState(seed)
    inputs = {"rgb": rng.randn(batch, height, width, 3).astype(np.float32),
              "depth": rng.randn(batch, height, width, 1).astype(np.float32)}
    # eager: the per-op compiles are shared by the configurations a file
    # runs, where a jit would compile each whole model anew
    want = dict(_leaves(jmodel.apply(variables, inputs)))
    with torch.no_grad():
        got = dict(_leaves(pmodel({k: torch.from_numpy(v)
                                   for k, v in inputs.items()})))
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    worst = (0.0, "")
    for path, w in want.items():
        g = got[path].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=path)
        worst = max(worst, (float(np.abs(g - w).max()), path))
    return worst
