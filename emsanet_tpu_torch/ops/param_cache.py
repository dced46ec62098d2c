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
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, Sequence

import torch


def cached(owner: Any, tag: Hashable, tensors: Sequence[torch.Tensor],
           build: Callable[[], Any]) -> Any:
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    entries = owner.__dict__.setdefault("_param_cache", {})
    hit = entries.get(tag)
    if hit is None or hit[0] != key:
        others = tuple(t for t in tensors
                       if t.untyped_storage() is not owner)
        hit = (key, others, build())
        entries[tag] = hit
    return hit[2]
