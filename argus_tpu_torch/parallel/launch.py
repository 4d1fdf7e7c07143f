"""Run a function on n ranks, one process each, on this machine: the
launcher of the dry-run, the CPU tests and the card's two-rank checks.

`run_ranks(fn, n, *args)` starts n processes with the `spawn` method (a
parent that has initialised CUDA can still start them), each joins a
process group on a free localhost port (`init_distributed`, with a
timeout, so a rank that never arrives fails the rendezvous instead of
hanging it) and returns `fn(rank, n, *args)`; the parent collects the n
results in rank order. It waits at most `timeout` seconds for all of
them: past it, or when a child fails, it kills every child and raises
with the child's traceback. No rank runs alone when the rendezvous
fails: the error ends the run.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_THREADS = 1  # torch threads a rank uses: the ranks share this machine's cores


def _child(rank, n, port, device, fn, args, out) -> None:
    try:
        import torch

        torch.set_num_threads(_THREADS)
        from argus_tpu_torch.parallel.mesh import init_distributed

        init_distributed(f"127.0.0.1:{port}", num_processes=n, process_id=rank, local_world_size=n,
                         device=device, timeout=_TIMEOUT)
        result = fn(rank, n, *args)
        buf = io.BytesIO()  # tensors by value: a queue would share them through memory the child frees
        torch.save(result, buf)
        out.put((rank, True, buf.getvalue()))
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - raised in the parent
        out.put((rank, False, traceback.format_exc()))


_TIMEOUT = 300.0  # seconds a rendezvous or a collective may wait in a child


def run_ranks(fn, n: int, *args, timeout: float = 600.0, device: str = "cpu") -> list:
    """[fn(rank, n, *args) for each rank], each in a process of its own on
    a group of n ranks, one node (gloo on the CPU; on `device="cuda"` the
    backend `init_distributed` picks for n ranks on this machine's cards).
    `fn` and its arguments must pickle (a module-level function); each
    child uses `_THREADS` torch threads. Raises RuntimeError when a child
    fails and TimeoutError past `timeout` seconds, after killing every
    child."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(r, n, port, device, fn, args, out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, failure = {}, None
    try:
        while len(results) < n and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {n - len(results)} of {n} ranks did not finish in {timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    failure = f"a rank exited with code {dead[0].exitcode} before returning"
                continue
            if ok:
                results[rank] = torch.load(io.BytesIO(value), weights_only=False)
            else:
                failure = f"rank {rank} failed:\n{value}"
        if failure is not None:
            raise RuntimeError(f"run_ranks: {failure}")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError("run_ranks: a rank did not exit after returning its result")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        out.close()
    return [results[r] for r in range(n)]


__all__ = ["free_port", "run_ranks"]
