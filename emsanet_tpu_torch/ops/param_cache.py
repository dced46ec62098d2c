"""Per-version cache of the values derived from parameters: a chain's or
a trunk's stacked parameters, a stem's packed weights and folded
BatchNorm, the polyphase taps of the semantic decode and the instance
head.

Deriving them on every call costs tens of small device launches and some
host time per frame. `cached(owner, tag, tensors, build)` returns
`build()`, computed again only when one of `tensors` moved to another
storage address or was written in place (its `_version` moved). The
entry lives on `owner`, so it goes with the model: a module, or the
storage of the parameter the values derive from (`untyped_storage()`:
every view of a parameter, such as the detached kernel that a decoder
hands to the decode each frame, shares that one storage object). It also
holds the tensors on other storages, so that their memory cannot go to
another tensor while the entry lives.

While `torch.export` traces (`tracing()`), the tensors are fake and hold
no data, so no key can be read: `cached` returns the entry an eager call
last built for the tag, which the traced program then holds as a
constant (`export_model.export_frame` makes one eager call just before
it traces, so the entries are those of the weights exported), and
builds anew, inside the traced graph, where there is none.
`device_constant` (the per-device copies of host constants) keeps
nothing it made while tracing.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Hashable, Sequence

import torch


def tracing() -> bool:
    """True while `torch.export` (or `torch.compile`) traces."""
    return torch.compiler.is_compiling()


def cached(owner: Any, tag: Hashable, tensors: Sequence[torch.Tensor],
           build: Callable[[], Any]) -> Any:
    if tracing():
        hit = owner.__dict__.get("_param_cache", {}).get(tag)
        return build() if hit is None else hit[2]
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    entries = owner.__dict__.setdefault("_param_cache", {})
    hit = entries.get(tag)
    if hit is None or hit[0] != key:
        others = tuple(t for t in tensors
                       if t.untyped_storage() is not owner)
        hit = (key, others, build())
        entries[tag] = hit
    return hit[2]


def device_constant(fn: Callable) -> Callable:
    """`fn(device, ...)` made once per argument tuple (a copy from
    pageable host memory makes the host wait for the device's queue on
    every call), except while tracing."""
    kept = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def get(*args):
        return fn(*args) if tracing() else kept(*args)

    return get
