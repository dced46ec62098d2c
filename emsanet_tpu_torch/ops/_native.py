"""Build and load the hand-written CUDA kernels (`emsanet_tpu_torch/csrc`).

Each `csrc/<name>.cu` has a plain C interface. It is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` into
`build/kernels/lib<name>-<hash>.so` inside the checkout at first use and
loaded with `ctypes`. The hash covers the source, every header of `csrc/`
and the flags, so an edited source or header is rebuilt. Nothing is
compiled when a module is imported: the CPU paths never reach this file.

`build_all()` starts one `nvcc` per source, all at once, and waits for
them; `load(name)` builds one source if it is missing.

`kernel_op` registers a kernel's wrapper as a `torch.library` custom op
`emsanet::<name>`: its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and its fake implementation gives
the output shapes and dtypes. The dispatcher so expresses the port's
rule (the kernel for a CUDA tensor, the plain version for a CPU tensor,
no fallback), the eager frame and `torch.export` take the same op, and
an exported program holds the kernels as calls of these ops (a ctypes
launch cannot run on the fake tensors `torch.export` traces with).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("stem", "nbt1d_chain", "grouping", "segment", "semantic_decode",
           "instance_head", "plane_interleave", "nbt1d_train",
           "semantic_train_head", "decoder_trunk")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # every header counts, so an edit to one rebuilds each source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> subprocess.Popen | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.emsanet_tmp = tmp  # type: ignore[attr-defined]
    proc.emsanet_out = out  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.emsanet_tmp, proc.emsanet_out)  # type: ignore[attr-defined]
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns nvcc's logs."""
    with _lock:
        procs = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, p) for name, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


_bound: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def bind(name: str, fn: str, n_args: int, int_args: List[int],
         float_args: Sequence[int] = ()):
    """`lib.fn` with argtypes: void* everywhere except the int and float
    positions. Bound once per function: the wrappers call this on every
    launch."""
    f = _bound.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = [
            ctypes.c_int if i in int_args
            else ctypes.c_float if i in float_args else ctypes.c_void_p
            for i in range(n_args)
        ]
        f.restype = ctypes.c_int
        _bound[(name, fn)] = f
    return f


# torch's private raw-stream accessor (CUDA builds only); None where a
# release lacks it, and then `stream_ptr` takes the public path
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(t: torch.Tensor) -> int:
    """The raw pointer of the current stream on t's card. The private
    accessor skips the `torch.cuda.Stream` object that
    `torch.cuda.current_stream(dev).cuda_stream` builds on every call."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(t.device).cuda_stream
    return _RAW_STREAM(t.get_device())


OP_NAMESPACE = "emsanet"


def kernel_op(name: str, schema: str, cuda: Callable, plain: Callable,
              fake: Callable):
    """The custom op `emsanet::<name>(<schema>)`: `cuda` for CUDA
    tensors, `plain` for CPU tensors, `fake` for tracing."""
    op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", cuda,
                                 mutates_args=(),
                                 device_types="cuda", schema=schema)
    op.register_kernel("cpu")(plain)
    op.register_fake(fake)
    return op


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def require_cuda_tensor(t: torch.Tensor, name: str, dtypes, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
