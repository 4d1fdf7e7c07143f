"""A function on the card as one CUDA graph: captured after a few eager
calls, then replayed, with the kernels' launch counts kept through the
replays. The resident training epoch's step (`train.make_resident_epoch_step`)
and the serving estimators' forward (`serve`) run through it; it is the
port's counterpart of a program argus_tpu compiles once with `jax.jit` and
then calls.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels import KERNELS

WARMUP_STEPS = 2  # calls a CapturedCall runs eagerly on its capture stream before it captures


def _clone(a):
    """The graph's static copy of an argument: tensors (also those in a
    dict) cloned, anything else the object itself."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


def _copy_into(static, a) -> None:
    if isinstance(a, torch.Tensor):
        static.copy_(a)
    elif isinstance(a, dict):
        for k, v in a.items():
            _copy_into(static[k], v)


class CapturedCall:
    """`fn(*args)`, which returns a tensor, on the card as one CUDA graph,
    captured once and replayed for every later call.

    The first `WARMUP_STEPS` calls run `fn` eagerly on the capture stream
    (they are calls of the run, their results returned): they fill what the
    kernels' wrappers make once per stream or shape (the one-launch
    reductions' ticket counters, the BN and weight-gradient plans, the resize
    matrices' nonzero ranges, each launcher's shared-memory opt-in, cuDNN's
    plans), which a capture could not. The next call captures
    (`capture_error_mode="thread_local"`, so that other threads may call CUDA
    meanwhile) and then replays. From there a call copies the tensors among
    `args` (and those of a dict among them) into the graph's static inputs,
    replays the graph on the current stream, behind whatever that stream
    holds, and returns the graph's output: the same tensor every time.
    Other arguments (a train state whose tensors are updated in place) pass
    through as they are and must keep their tensors' addresses, as must
    anything `fn` reads besides its arguments. A capture that fails raises.

    Kernel launch counts: a kernel the graph holds counts one launch a
    replay for each call its wrapper made during the capture, in which no
    kernel ran (those calls' counts are taken back)."""

    def __init__(self, fn, device) -> None:
        self.fn = fn
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.eager_left = WARMUP_STEPS
        self.graph = None
        self.static = None  # the graph's input arguments
        self.out = None  # its output
        self.per_replay = []  # (Kernel, launches a replay)

    def __call__(self, *args):
        current = torch.cuda.current_stream(self.device)
        if self.graph is None:
            self.stream.wait_stream(current)
            if self.eager_left > 0:
                self.eager_left -= 1
                with torch.cuda.stream(self.stream):
                    out = self.fn(*args)
                current.wait_stream(self.stream)
                out.record_stream(current)
                return out
            self._capture(args)
        for static, a in zip(self.static, args):
            _copy_into(static, a)
        self.graph.replay()
        for kernel, n in self.per_replay:
            kernel.launches += n
        return self.out

    def _capture(self, args) -> None:
        self.static = [_clone(a) for a in args]
        before = {name: k.launches for name, k in KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            self.out = self.fn(*self.static)
        self.per_replay = []
        for name, k in KERNELS.items():
            n = k.launches - before[name]
            if n:
                k.launches -= n
                self.per_replay.append((k, n))
        self.graph = graph
