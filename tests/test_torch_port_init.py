"""The training model's initialization against the reference's.

`build_train_model` must start from what the reference's `main.py`
starts from: flax's `init_model` (`emsanet_tpu/models/emsanet.py:357`).
The two packages draw from different generators, so the test compares
constants exactly and random tensors by their distribution: the R18
flagship at 64x64, flax's `init_model(..., train=True)` mapped through
the port's converter (`weights.flax_to_state_dict`), against
`build_train_model(..., seed=0)`.

- Constant tensors (BatchNorm scales, shifts, running means and
  variances, the zero-init residual scales, every bias, the
  bilinear-mimic upsampling kernels) must equal flax's exactly.
- Random tensors (conv and dense kernels): each one's std, pooled over
  16 draws on each side (flax keys 0..15, port seeds 0..15), must lie
  within 5% of flax's; within 1% where the tensor has more than 10^4
  elements. Pooled, the smallest tensors (256 elements) give 4096
  samples a side, a relative standard error of 1.6% on the difference;
  the tensors above 10^4 elements stay under 0.18%. Each tensor must also
  be truncated (`lecun_normal`: no value beyond 2 / 0.8796 = 2.27 of its
  std) or not (He-normal, the encoder fusion's SE layers: of >= 4096
  normal samples the largest lies near 3.5 std) exactly where flax's is,
  told apart at 2.6 std, and its pooled mean lie within 4 standard errors
  of 0.

`tests/test_torch_port_variants_init.py` holds a second configuration to
the same checks.
"""

import jax
import numpy as np
import pytest
import torch

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.emsanet import (
    EMSANet,
    build_model,
    build_train_model,
)
from emsanet_tpu_torch.models.layers import NonBottleneck1D
from emsanet_tpu_torch.weights import (
    flax_to_state_dict,
    random_init_,
    reference_init_,
)

DRAWS = 16
TRUNC_CUT = 2.6  # max |w| / std: 2.27 truncated, ~3.5 untruncated
MODEL = dict(tasks=("semantic", "instance", "orientation", "scene"),
             enable_panoptic=True, input_height=64, input_width=64,
             rgb_encoder_backbone="resnet18",
             depth_encoder_backbone="resnet18")


def _random_key(key: str) -> bool:
    """Conv and dense kernels, but not the depthwise upsamplings or the
    norms' scales."""
    return key.endswith(".weight") and not any(
        n in key for n in ("BatchNorm", "LayerNorm", "GroupNorm",
                           "depthwise"))


class _Pooled:
    """Per-tensor sums over draws: count, sum, sum of squares, max |x|."""

    def __init__(self):
        self.n, self.s, self.s2, self.amax = {}, {}, {}, {}

    def add(self, state):
        for key, v in state.items():
            if not _random_key(key):
                continue
            v = np.asarray(v, np.float64).reshape(-1)
            self.n[key] = self.n.get(key, 0) + v.size
            self.s[key] = self.s.get(key, 0.0) + v.sum()
            self.s2[key] = self.s2.get(key, 0.0) + (v * v).sum()
            self.amax[key] = max(self.amax.get(key, 0.0), np.abs(v).max())

    def stats(self, key):
        n = self.n[key]
        mean = self.s[key] / n
        std = np.sqrt(self.s2[key] / n - mean * mean)
        return mean, std, self.amax[key] / std, n


def _one_thread(model_kw):
    # one intra-op thread: an idle pool's threads would spin beside the
    # JAX work of the other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _inits(model_kw)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inits():
    return _one_thread(MODEL)


def _inits(model_kw):
    jcfg = JaxEMSANetConfig(model=JaxModelConfig(**model_kw),
                            data=JaxDataConfig(dataset="synthetic")).validate()
    jmodel = JaxEMSANet(cfg=jcfg.model,
                        dataset_config=jax_ds_config(jcfg.data))
    init = jax.jit(lambda k: init_model(jmodel, k, train=True))
    cfg = pc.flagship_config(fused_training=True, **{
        "enable_panoptic": False, **model_kw})
    model = build_train_model(cfg, get_dataset_config("synthetic"),
                              device="cpu", seed=0)
    port0 = {k: v.clone().numpy() for k, v in model.state_dict().items()}
    flax0 = None
    flax_pool, port_pool = _Pooled(), _Pooled()
    for i in range(DRAWS):
        f = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, init(jax.random.PRNGKey(i))))
        flax_pool.add(f)
        flax0 = f if flax0 is None else flax0
        if i:
            reference_init_(model, i)
        port_pool.add(model.state_dict())
    flax0 = {k: v.numpy() for k, v in flax0.items()}
    return flax0, port0, flax_pool, port_pool, model


def test_same_tensors(inits):
    flax0, port0, *_ = inits
    assert sorted(flax0) == sorted(port0)
    for k in flax0:
        assert flax0[k].shape == port0[k].shape, k


def test_constants_equal_flax(inits):
    flax0, port0, _, _, model = inits
    constants = [k for k in flax0 if not _random_key(k)]
    zero_scales = [k for k in constants if k.endswith("BatchNorm_0.weight")
                   and not flax0[k].any()]
    # the decoders' zero-init residual scales, 3 blocks x 3 modules x 2
    n_zero_init = sum(1 for m in model.modules()
                      if isinstance(m, NonBottleneck1D)
                      and m.zero_init_residual)
    assert len(zero_scales) == n_zero_init == 18
    assert any(k.endswith("running_var") for k in constants)
    assert any("depthwise" in k for k in constants)
    for k in constants:
        np.testing.assert_array_equal(port0[k], flax0[k], err_msg=k)


def test_random_tensors_match_flax_distribution(inits):
    flax0, _, flax_pool, port_pool, _ = inits
    keys = [k for k in flax0 if _random_key(k)]
    assert len(keys) > 150
    he = 0
    for k in keys:
        fm, fs, fmax, n = flax_pool.stats(k)
        pm, ps, pmax, pn = port_pool.stats(k)
        assert pn == n
        tol = 0.01 if flax0[k].size > 10_000 else 0.05
        assert abs(ps / fs - 1) <= tol, (k, ps, fs)
        assert abs(pm) <= 4 * ps / np.sqrt(n), (k, pm)
        truncated = fmax <= TRUNC_CUT
        assert (pmax <= TRUNC_CUT) == truncated, (k, pmax, fmax)
        he += not truncated
    # He-normal: the 20 dense layers of the 5 SE fusions
    assert he == 20


def test_reference_init_std_values(inits):
    """The stem's lecun std and the zero-init scales of C1's report."""
    _, port0, _, port_pool, _ = inits
    std = port_pool.stats("encoder.rgb_stem.Conv_0.weight")[1]
    assert abs(std * np.sqrt(7 * 7 * 3) - 1) < 0.01
    assert not port0["encoder.rgb_stem.Norm_0.BatchNorm_0.running_mean"].any()


def test_build_model_keeps_bench_weights():
    """The bench's random weights (`random_init_`) are unchanged."""
    cfg = pc.flagship_config(compute_dtype="float32", **MODEL)
    ds = get_dataset_config("synthetic")
    got = build_model(cfg, ds, device="cpu", seed=0).state_dict()
    ref = random_init_(EMSANet(cfg, ds), 0).state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    var = got["encoder.rgb_stem.Norm_0.BatchNorm_0.running_var"]
    assert float(var.min()) >= 0.5 and float(var.max()) <= 1.5
    assert not torch.equal(var, torch.ones_like(var))
