"""Build and bind the hand-written CUDA kernels of `argus_tpu_torch/csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into its own
shared library with a plain C interface, and loaded with `ctypes`: no
PyTorch headers, no ninja, a few seconds per source. Libraries go to
`argus_tpu_torch/_build/`, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. The build runs at
the first launch of a kernel, or for all sources at once (one `nvcc` process
each, in parallel) through `build()`.

A C launcher takes device pointers (None for an optional output) and ints,
then the CUDA stream, and
returns `cudaGetLastError()` after its launches; `Kernel.launch` raises on
anything but 0 and counts successful calls in `Kernel.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the kernel sources, one shared library each
SOURCES = (
    "stem_fused", "block_fused", "proj_fused", "stage_fused",
    "block_fused_bwd", "proj_fused_bwd", "stage_fused_bwd", "blur", "augment_fused",
    "basic_fused", "basic_fused_bwd", "stem_fused_bwd", "bn_reduce",
    "pointwise", "pointwise_bwd", "block_fused_rbwd", "bwd_prev",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output (with ptxas' register and spill report) of the last build."""
    return BUILD_DIR / f"{name}.log"


def build(names=SOURCES) -> dict:
    """Compile every named source that is not built yet, one nvcc process per
    source, all started together. Returns {name: seconds} for those built;
    raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        log = open(log_path(name), "w")
        started[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp, out,
                         time.perf_counter())
    took, failed = {}, []
    for name, (proc, log, tmp, out, t0) in started.items():
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{log_path(name).read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    lib.argus_error_string.argtypes = [ctypes.c_int]
    lib.argus_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _stream_api():
    """(the current raw CUDA stream of a device index, the current device
    index): torch's private calls where this torch has them (~8 us of host
    time a launch less than a Stream object and a device switch, which the
    small BN reductions feel), else the public ones."""
    import torch

    fast = getattr(torch._C, "_cuda_getCurrentRawStream", None), getattr(torch._C, "_cuda_getDevice", None)
    if all(fast):
        return fast
    return (lambda index: torch.cuda.current_stream(index).cuda_stream), torch.cuda.current_device


def current_stream(index: int) -> int:
    """The current CUDA stream of device `index`, as a raw handle."""
    return _stream_api()[0](index)


TICKET_WORDS = 64
_TICKETS: dict = {}  # (device index, raw stream) -> the stream's ticket counters


def tickets(x):
    """The ticket counters of the one-launch reductions (the last block to
    draw a ticket adds the blocks' partial sums) on x's device and its
    current stream: TICKET_WORDS 32-bit words, zeroed when made (on that
    stream, before the first launch) and left 0 by every launch's last
    blocks. Launches on one stream run one after another, so they may share
    them; two streams never do."""
    import torch

    index = x.device.index
    key = (index, current_stream(index))
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(TICKET_WORDS, dtype=torch.int32, device=x.device)
    return t


class Kernel:
    """One C launcher of a kernel library, with its launch count."""

    def __init__(self, source: str, symbol: str, argtypes) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0

    @functools.cached_property
    def _fn(self):
        fn = getattr(_library(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the launcher with `args` (tensors as their device pointers,
        ints as ints) and, last, the current CUDA stream of the first
        tensor's device, the argument order every launcher follows. The
        launch goes to the current device: it is switched to the tensor's
        only when they differ (host time, `_stream_api`)."""
        import torch

        index = next(a.device for a in args if isinstance(a, torch.Tensor)).index
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        stream_of, device = _stream_api()
        stream = stream_of(index)
        if index == device():
            err = self._fn(*cargs, stream)
        else:
            with torch.cuda.device(index):
                err = self._fn(*cargs, stream)
        if err != 0:
            msg = _library(self.source).argus_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {err} ({msg})")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64

