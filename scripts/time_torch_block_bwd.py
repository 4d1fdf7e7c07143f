#!/usr/bin/env python3
"""Time the redesigned kernels of one tree of the port on one NVIDIA GPU: the
BasicBlock's and the projection block's backwards (`basic_fused.basic_bwd`,
`proj_fused.proj_bwd`) at the seven geometries of the keypoint and flagship
train steps, the identity bottleneck's saved-residual and recompute
backwards (`block_fused.block_bwd`, `block_fused.block_bwd_recompute`) at its
four geometries, the stage-0 chain's backward (`stage_fused.stage_bwd`),
the BasicBlock forward (`basic_fused.basic_block`) at ResNet-18's four
geometries, the identity bottleneck's forward (`block_fused.bottleneck_block`)
at its three geometries of stages 1-3, the pointwise backward
(`pointwise.pointwise_bwd`) at configuration P's twelve, the projection
block's saving forward (`proj_fused.projection_block_save`) at its three
stride-2 geometries, the frozen stages' whole-stage chains
(`stage_fused.fused_stage`, stages 1 and 2), the stage-0 chain's saving
forward (`stage_fused.fused_stage_save`), the pointwise forward
(`pointwise.pointwise_fwd`) at configuration P's twelve geometries and
BatchNorm's two reductions (`bn_reduce.fused_stats`,
`bn_reduce.fused_bn_bwd_reduce`) at ResNet-50's twelve (M, C) at strides 1
and 4 (N = 512 camera images of 256x256, bf16), and break each call down by
device kernel with `torch.profiler`: data gradient, weight gradient, split
sum, the relu mask pass, forward convs (the recompute's h1/h2, the mma.sync
forwards), forward convs on the TMA engine, the BN reductions (the
one-launch stream, the previous reduction), the rest.

    python3 scripts/time_torch_block_bwd.py [--root DIR] [--engine new|prev] [--reps 10] [--rows ROW,...]

`--root` is the checkout whose `argus_tpu_torch` is imported (default: this
one), so a parent commit unpacked with `git archive` under `_trees/parent`
is timed by the same script in the same call:

    python3 scripts/time_torch_block_bwd.py --root _trees/parent
    python3 scripts/time_torch_block_bwd.py
    python3 scripts/time_torch_block_bwd.py
    python3 scripts/time_torch_block_bwd.py --root _trees/parent

`--engine prev` times `ops/kernels/bwd_prev.py` (the kernels in the form
they had before their redesign, from this tree) instead of the wrappers. `--rows` keeps the rows whose name starts with one of the given
prefixes. Times are the mean of `--reps` calls between CUDA events after a
warm-up; the breakdown is one profiled call. Prints one line per geometry
and, last, one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

N_IMG = 512
# (C, H = W, blocks per keypoint step) of ResNet-18's identity BasicBlocks
BASIC = [(64, 64, 2), (128, 32, 1), (256, 16, 1), (512, 8, 1)]
# (H = W, CIN, F) of ResNet-50's stride-2 projection blocks, COUT = 4F, one per step
PROJ = [(64, 256, 128), (32, 512, 256), (16, 1024, 512)]
# (H = W, CIN, F, blocks per step) of ResNet-50's identity bottlenecks in stages
# 1-3, and stage 0's (which runs in the stage chain: 0 a step)
IDENTITY = [(64, 256, 64, 0), (32, 512, 128, 3), (16, 1024, 256, 5), (8, 2048, 512, 2)]
# the stage-0 chain of ResNet-50 (H = W, CIN, F, COUT, identity blocks), once a step
CHAIN = (64, 64, 64, 256, 2)
# the whole-stage chains of frozen stages 1-2 (H = W, CIN, F, COUT, identity
# blocks), stride 2, once each per frozen_stages=3 fine-tune step
FROZEN_CHAINS = [(64, 256, 128, 512, 3), (32, 512, 256, 1024, 5)]
# configuration P's pointwise convs (H = W, CIN, COUT, residual, calls per step):
# Conv_0 and Conv_2 of the 16 bottlenecks
POINTWISE = [
    (64, 64, 64, False, 1), (64, 256, 64, False, 2), (64, 64, 256, True, 3), (64, 256, 128, False, 1),
    (32, 512, 128, False, 3), (32, 128, 512, True, 4), (32, 512, 256, False, 1), (16, 1024, 256, False, 5),
    (16, 256, 1024, True, 6), (16, 1024, 512, False, 1), (8, 2048, 512, False, 2), (8, 512, 2048, True, 3),
]


def bn_inputs(n: int = N_IMG, hw: int = 256) -> list:
    """(M, C, count) of the inputs of ResNet-50's 53 BatchNorms for n
    images of hw x hw, grouped by shape: the stem's, then per stage the entry
    block's BN0 (before the stride), BN1, BN2 and projection, and the
    identity blocks' BN0-2."""
    shapes = {(n * (hw // 2) ** 2, 64): 1}
    side = hw // 4
    for i, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2**i
        out = side if i == 0 else side // 2
        for m, c, k in ((n * side * side, f, 1), (n * out * out, f, 1 + 2 * (blocks - 1)),
                        (n * out * out, 4 * f, 2 + (blocks - 1))):
            shapes[(m, c)] = shapes.get((m, c), 0) + k
        side = out
    assert sum(shapes.values()) == 53
    return [(m, c, k) for (m, c), k in shapes.items()]


def kind(name: str) -> str:
    """The launch a device kernel's name belongs to."""
    if "sum_splits" in name or "wgrad_sum" in name:
        return "split sum"
    if "wgrad" in name:
        return "weight gradient"
    if "conv_fwd_tma" in name:  # the block and chain forwards: the TMA engine
        return "forward conv (TMA)"
    if "conv_fwd" in name or "conv_gemm_kernel<false>" in name:  # the recompute's h1/h2, mma.sync forwards
        return "forward conv"
    if "conv_gemm" in name or "dgrad" in name:
        return "data gradient"
    if "relu_mask" in name:
        return "mask pass"
    if "stream_kernel" in name:  # the BN reductions' one-launch stream
        return "BN stream"
    if "reduce_kernel" in name or "reduce_splits" in name:  # their previous two launches
        return "BN reduce"
    return "other"


def breakdown(fn, detail: bool = False) -> dict:
    """{kind: [device ms, launches]} of one call of `fn` (after a warm-up),
    from torch.profiler's key_averages(); with `detail`, each kernel's full
    name too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        for key in (kind(ev.key), ev.key) if detail else (kind(ev.key),):
            entry = out.setdefault(key, [0.0, 0])
            entry[0] += us / 1e3
            entry[1] += ev.count
    return out


def cuda_ms(fn, reps: int):
    """(ms per call between CUDA events, ms per call of the host's enqueue)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def cases(engine: str = "new"):
    """Yields (row, label, calls per step or eval forward, the call) at the
    seven BasicBlock and projection geometries, at the identity block's four
    (the saved-residual and the recompute backward each), for the stage-0
    chain's backward, for the BasicBlock forward at its four geometries, for
    the identity forward at its three of stages 1-3, for the pointwise
    backward at configuration P's twelve, for the projection's saving
    forward at its three stride-2 geometries, the frozen stages' two chains
    and the stage-0 chain's saving forward, the pointwise forward at
    configuration P's twelve, and the BN reductions at ResNet-50's twelve
    (M, C) at strides 1 and 4 (per Path B step: stride 1 times its count,
    stride 4 none); inputs from seed 0, h1/h2/out from the tree's saving
    forwards (the relu masks the backward sees in training)."""
    import torch

    from argus_tpu_torch.ops.kernels import basic_fused, block_fused, bn_reduce, pointwise, proj_fused, stage_fused

    if engine == "prev":
        from argus_tpu_torch.ops.kernels import bwd_prev

        basic_bwd, proj_bwd = bwd_prev.basic_bwd_prev, bwd_prev.proj_bwd_prev
        block_bwd, block_rbwd = bwd_prev.block_bwd_prev, bwd_prev.block_bwd_recompute_prev
        stage_bwd, basic_fwd = bwd_prev.stage_bwd_prev, bwd_prev.basic_fwd_prev
        block_fwd, pw_bwd = bwd_prev.block_fwd_prev, bwd_prev.pointwise_bwd_prev
        proj_fwd_save = functools.partial(bwd_prev.proj_fwd_prev, save=True)
        stage_fwd, stage_fwd_save = bwd_prev.stage_fwd_prev, bwd_prev.stage_fwd_save_prev
        pw_fwd, bn_stats, bn_bwd = bwd_prev.pointwise_fwd_prev, bwd_prev.bn_stats_prev, bwd_prev.bn_bwd_reduce_prev
    else:
        basic_bwd, proj_bwd = basic_fused.basic_bwd, proj_fused.proj_bwd
        block_bwd, block_rbwd = block_fused.block_bwd, block_fused.block_bwd_recompute
        stage_bwd, basic_fwd = stage_fused.stage_bwd, basic_fused.basic_block
        block_fwd, pw_bwd = block_fused.bottleneck_block, pointwise.pointwise_bwd
        proj_fwd_save = proj_fused.projection_block_save
        stage_fwd, stage_fwd_save = stage_fused.fused_stage, stage_fused.fused_stage_save
        pw_fwd, bn_stats, bn_bwd = pointwise.pointwise_fwd, bn_reduce.fused_stats, bn_reduce.fused_bn_bwd_reduce
    g = torch.Generator(device="cuda").manual_seed(0)

    def w(*shape):
        fan_in = 1
        for s in shape[:-1]:
            fan_in *= s
        return (torch.randn(*shape, generator=g, device="cuda") / fan_in**0.5).to(torch.bfloat16)

    def b(c):
        return 0.1 * torch.randn(1, c, generator=g, device="cuda")

    def grad(t):
        return torch.randn(t.shape, generator=g, device="cuda").to(torch.bfloat16)

    for c, h, count in BASIC:
        x = torch.rand(N_IMG, h, h, c, generator=g, device="cuda").to(torch.bfloat16)
        ws = (w(3, 3, c, c), b(c), w(3, 3, c, c), b(c))
        out, h1 = basic_fused.basic_block_save(x, *ws)
        args = (x, grad(out), out, h1, ws[0], ws[2])
        yield "basic_fused_bwd", f"{tuple(x.shape)}", count, lambda args=args: basic_bwd(*args)
        del x, out, h1, args
    for h, cin, f in PROJ:
        cout = 4 * f
        x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = (w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout), w(cin, cout), b(cout))
        out, h1, h2 = proj_fused.projection_block_save(x, *pw, 2)
        args = (x, grad(out), out, h1, h2, pw[0], pw[2], pw[4], pw[6], 2)
        yield "proj_fused_bwd", f"{tuple(x.shape)} F={f} S=2", 1, lambda args=args: proj_bwd(*args)
        del x, out, h1, h2, args
    for h, cin, f, count in IDENTITY:
        x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        iw = (w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cin), b(cin))
        out, h1, h2 = block_fused.bottleneck_block_save(x, *iw)
        gr = grad(out)
        label = f"{tuple(x.shape)} F={f}"
        args = (x, gr, out, h1, h2, iw[0], iw[2], iw[4])
        yield "block_fused_bwd", label, count, lambda args=args: block_bwd(*args)
        args = (x, gr, out, *iw)
        yield "block_fused_rbwd", label, count, lambda args=args: block_rbwd(*args)
        del x, out, h1, h2, gr, args
    torch.cuda.empty_cache()
    h, cin, f, cout, k = CHAIN
    x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
    pw = (w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout), w(cin, cout), b(cout))
    ids = [(w(cout, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout)) for _ in range(k)]
    out, bnds, h1s, h2s = stage_fused.fused_stage_save(x, pw, ids, 1)
    args = (x, grad(out), out, bnds, h1s, h2s, (pw[0], pw[2], pw[4], pw[6]), [(t[0], t[2], t[4]) for t in ids], 1)
    label = f"{tuple(x.shape)} F={f} K={k}"
    yield "stage_fused_bwd", label, 1, lambda args=args: stage_bwd(*args)
    del x, out, bnds, h1s, h2s, args
    torch.cuda.empty_cache()
    for c, h, count in BASIC:
        x = torch.rand(N_IMG, h, h, c, generator=g, device="cuda").to(torch.bfloat16)
        ws = (w(3, 3, c, c), b(c), w(3, 3, c, c), b(c))
        label = f"{tuple(x.shape)}"
        yield "basic_fused", label, count, lambda x=x, ws=ws: basic_fwd(x, *ws)
        del x
    torch.cuda.empty_cache()
    for h, cin, f, count in IDENTITY[1:]:
        x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        iw = (w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cin), b(cin))
        yield "block_fused", f"{tuple(x.shape)} F={f}", count, lambda x=x, iw=iw: block_fwd(x, *iw)
        del x
    torch.cuda.empty_cache()
    for h, cin, cout, with_res, count in POINTWISE:
        m = N_IMG * h * h
        x = torch.randn(m, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = (w(cin, cout), b(cout))
        res = torch.randn(m, cout, generator=g, device="cuda").to(torch.bfloat16) if with_res else None
        out = pointwise.pointwise_fwd(x, *pw, res)
        args = (grad(out), out, x, pw[0], True, with_res)
        label = f"M={m} {cin}->{cout}{' +res' if with_res else ''}"
        yield "pointwise_bwd", label, count, lambda args=args: pw_bwd(*args)
        del x, res, out, args
    torch.cuda.empty_cache()
    for h, cin, f in PROJ:
        cout = 4 * f
        x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = (w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout), w(cin, cout), b(cout))
        yield "proj_fused_save", f"{tuple(x.shape)} F={f} S=2", 1, lambda x=x, pw=pw: proj_fwd_save(x, *pw, 2)
        del x
    torch.cuda.empty_cache()
    for h, cin, f, cout, k in FROZEN_CHAINS:
        x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = (w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout), w(cin, cout), b(cout))
        ids = [(w(cout, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout)) for _ in range(k)]
        label = f"{tuple(x.shape)} F={f} S=2 K={k}"
        yield "stage_fused_frozen", label, 1, lambda x=x, pw=pw, ids=ids: stage_fwd(x, pw, ids, 2)
        del x
    torch.cuda.empty_cache()
    h, cin, f, cout, k = CHAIN
    x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
    pw = (w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout), w(cin, cout), b(cout))
    ids = [(w(cout, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout)) for _ in range(k)]
    label = f"{tuple(x.shape)} F={f} K={k}"
    yield "stage_fused_save", label, 1, lambda x=x, pw=pw, ids=ids: stage_fwd_save(x, pw, ids, 1)
    del x
    torch.cuda.empty_cache()
    for h, cin, cout, with_res, count in POINTWISE:
        m = N_IMG * h * h
        x = torch.randn(m, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = (w(cin, cout), b(cout))
        res = torch.randn(m, cout, generator=g, device="cuda").to(torch.bfloat16) if with_res else None
        label = f"M={m} {cin}->{cout}{' +res' if with_res else ''}"
        yield "pointwise", label, count, lambda x=x, pw=pw, res=res: pw_fwd(x, *pw, res)
        del x, res
    torch.cuda.empty_cache()
    for m, c, count in bn_inputs():
        x = torch.randn(m, c, generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn(m, c, generator=g, device="cuda").to(torch.bfloat16)
        mean = 0.1 * torch.randn(c, generator=g, device="cuda")
        rstd = 0.5 + torch.rand(c, generator=g, device="cuda")
        for stride in (1, 4):
            label = f"({m}, {c}) stride {stride}"
            calls = count if stride == 1 else 0
            yield "bn_stats", label, calls, lambda x=x, s=stride: bn_stats(x, s)
            yield "bn_bwd_reduce", label, calls, lambda x=x, dy=dy, mean=mean, rstd=rstd, s=stride: bn_bwd(
                x, dy, mean, rstd, s)
        del x, dy
    torch.cuda.empty_cache()


KINDS = ("data gradient", "weight gradient", "split sum", "mask pass", "forward conv", "forward conv (TMA)",
         "BN stream", "BN reduce", "other")


def fmt(parts: dict) -> str:
    return ", ".join(f"{k} {parts[k][0]:.3f} ms ({parts[k][1]} launches)" for k in KINDS if k in parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--engine", choices=("new", "prev"), default="new")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--detail", action="store_true", help="also print each device kernel's time")
    ap.add_argument("--rows", default="", help="comma-separated prefixes of the rows to time (default: all)")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_torch_block_bwd: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from argus_tpu_torch.ops.kernels import _build

    if not _build.PACKAGE_DIR.is_relative_to(root):
        raise RuntimeError(f"imported {_build.PACKAGE_DIR}, not the tree under {root}")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rows = []
    keep = tuple(r for r in a.rows.split(",") if r)
    for row, label, count, fn in cases(a.engine):
        if keep and not row.startswith(keep):
            continue
        ms, host = cuda_ms(fn, a.reps)
        parts = breakdown(fn, a.detail)
        for key, (kms, n) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
            if a.detail and key not in KINDS:
                print(f"    {kms:.3f} ms, {n} launches: {key[:160]}")
        print(f"{root} {a.engine} {row} {label} x{count}: {ms:.3f} ms per call (host enqueue {host:.3f}); "
              f"{fmt(parts)}  [{gpu}]", flush=True)
        rows.append({"row": row, "label": label, "count": count, "ms": ms, "host_ms": host,
                     "breakdown": {k: v[0] for k, v in parts.items() if k in KINDS},
                     "launches": {k: v[1] for k, v in parts.items() if k in KINDS}})
    print(json.dumps({"root": root, "engine": a.engine, "gpu": gpu, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
