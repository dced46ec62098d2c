"""The port's bf16 train step against the JAX package's bf16 step, on the
CPU: the configuration, weights and batch of tests/test_torch_port_train.py
(R18, 64x64, b4, dropout 0; the port with `fused_training` and
`MIN_PIXELS` = 0), both with bf16 compute and f32 parameters. The port
casts its f32 parameters to bf16 at each conv as flax does; the two
round at slightly different places (flax adds the conv bias in bf16
after rounding the conv), so the comparison is of losses only.
"""

import jax
import numpy as np
import torch
from test_torch_port_model import _random_variables
from test_torch_port_train import (
    JaxEMSANet,
    _jax_cfg,
    _jax_step,
    _port_batch,
    _port_step,
    init_model,
    jax_ds_config,
)


def test_bf16_train_step_matches_jax_bf16():
    jcfg = _jax_cfg("bfloat16")
    shapes = jax.eval_shape(
        lambda k: init_model(JaxEMSANet(cfg=jcfg.model,
                                        dataset_config=jax_ds_config(
                                            jcfg.data)),
                             k, batch_size=1, train=True),
        jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), 3)
    loader, ds = _port_batch()
    batch = next(iter(loader.batches(0)))
    cw = ds.semantic_compute_class_weights()
    jl = _jax_step(jcfg, variables, batch, cw)[0]
    pl = _port_step(variables, batch, cw, torch.bfloat16)[0]
    # the total at 2e-2 (measured 8e-3); in bf16 the single instance
    # losses differ by up to 3.5%: their side outputs at 1/32 pass
    # BatchNorms over 16 values, which magnify bf16 rounding
    np.testing.assert_allclose(pl["total_loss"], jl["total_loss"], rtol=2e-2)
    for key, want in jl.items():
        np.testing.assert_allclose(pl[key], want, rtol=5e-2, err_msg=key)
