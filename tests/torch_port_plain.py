"""The port's preprocessing on its plain (numpy) versions, for tests.

`plain_host_library()` swaps the host library that
`emsanet_tpu_torch.preprocessing.transforms` calls for the numpy bodies
beside it, inside a `with` block: the preprocessing then runs the JAX
package's numpy path. Tests use it to hold the plain versions against
the JAX package with its native library off, and to keep the train-step
tests on the batch they were calibrated with.
"""

import contextlib
import types

import numpy as np
import pytest

from emsanet_tpu_torch.preprocessing import transforms


def _resize_bilinear_u8(src, h, w):
    return np.round(transforms._resize_bilinear_plain(src, h, w)).astype(
        np.uint8)


PLAIN = types.SimpleNamespace(
    resize_nearest_i32=transforms._resize_nearest_plain,
    resize_bilinear_f32=transforms._resize_bilinear_plain,
    resize_bilinear_u8=_resize_bilinear_u8,
    hsv_jitter=transforms._hsv_jitter_plain,
    instance_targets=transforms._instance_targets_plain,
    normalize_rgb=lambda rgb, mean, std: transforms._normalize_rgb_plain(
        rgb),
)


@contextlib.contextmanager
def plain_host_library():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transforms, "native", PLAIN)
        yield
