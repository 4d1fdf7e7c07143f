"""Tracing and profiling utilities.

Port of `argus_tpu/profiling.py` onto `torch.profiler`:

  * `trace(...)`: a context manager that records the enclosed block's host
    ops and, on a card, its CUDA kernels and copies (CUPTI), and writes a
    Chrome-trace JSON (Perfetto and chrome://tracing open it) into the
    directory it yields;
  * `annotate(name)`: a named region (`torch.profiler.record_function`)
    that shows in the trace around the kernels launched inside it;
  * `profile_fn(fn)`: wall-clock statistics (mean, p50, p95) of a thunk,
    each call's result synchronised on its device before the clock is read.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from argus_tpu_torch import ROOT
from argus_tpu_torch.utils import _synchronize

TRACE_FILE = "trace.json"
PERFETTO_FILE = "perfetto_trace.json.gz"  # the name jax.profiler gives its Perfetto trace


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, create_perfetto_trace: bool = False):
    """Record a `torch.profiler` trace of the enclosed block into
    `log_dir/trace.json` (default `outputs/traces` under the repository),
    CUDA activity included where a card is present; with
    `create_perfetto_trace` also a gzipped copy, `perfetto_trace.json.gz`.
    Yields the directory.

        with profiling.trace("outputs/traces/run1"):
            state, loss = train_step(state, batch)
            loss.item()
    """
    log_dir = log_dir or os.path.join(ROOT, "outputs", "traces")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the window
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if create_perfetto_trace:
        with open(path, "rb") as src, gzip.open(os.path.join(log_dir, PERFETTO_FILE), "wb") as dst:
            shutil.copyfileobj(src, dst)


def annotate(name: str):
    """Named trace region: `with profiling.annotate("augmentation"): ...`."""
    return torch.profiler.record_function(name)


def profile_fn(fn: Callable[[], object], n_trials: int = 20, warmup: int = 2) -> dict:
    """Time a thunk by the host's clock, `warmup` untimed calls first; each
    call's result (a tensor, or a tuple, list or dict of them) is
    synchronised on its CUDA device before the clock is read. Returns
    {"mean_ms", "p50_ms", "p95_ms", "n_trials"}."""
    for _ in range(warmup):
        _synchronize(fn())
    times = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        _synchronize(fn())
        times.append(time.perf_counter() - t0)
    times_ms = np.asarray(times) * 1e3
    return {
        "mean_ms": float(times_ms.mean()),
        "p50_ms": float(np.percentile(times_ms, 50)),
        "p95_ms": float(np.percentile(times_ms, 95)),
        "n_trials": n_trials,
    }
