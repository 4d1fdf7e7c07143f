#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (argus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and ignored):

1. build every CUDA kernel of the serving path from `argus_tpu_torch/csrc/`
   (one nvcc per source, in parallel) and print the seconds and ptxas'
   register/spill report;
2. per kernel, at the serving shapes of a batch of 256 two-camera frames
   (N = 512 camera images at 256x256): hold the CUDA kernel against its plain
   PyTorch version on the same bf16 inputs, max |kernel - plain| <=
   2e-2 * max |plain| + 1e-2 (one bf16 rounding of f32 sums taken in another
   order), and time the kernel, the plain version and the cuDNN composition of
   the same function (`library_ms`, bf16 channels-last `F.conv2d` calls) with
   CUDA events;
3. end to end: a full-width ResNet-50 NCameraCNN (2 cameras, 1024-d
   features, random weights from a seeded generator, BN buffers and scales
   randomised) saved as an argus_tpu format-2 checkpoint, served by
   `Estimator(ckpt, batch_size=256)` on the card; the launch counts of one
   `predict` must be 1 stem / 1 stage / 3 projection / 10 identity, and the
   poses must match `Estimator(ckpt, batch_size=8, device="cpu")` on the first
   8 rows within atol 0.05 (bf16 on both sides);
4. the `kernels` JSON line, the card's name and power limit, and the result
   line `{"ok": true, "device": {...}}` last.

Exits non-zero, printing no result, without a CUDA device or without the
package beside it. Imports nothing of JAX or argus_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 256  # serving batch: rows of two-camera frames
N_IMG = 2 * N_ROWS  # camera images through the backbone
HW = 256
TOL_REL, TOL_ABS = 2e-2, 1e-2  # kernel vs plain, bf16 outputs
POSE_ATOL = 0.05  # GPU bf16 serving vs CPU bf16 serving
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
BF = 2  # bytes per bf16

REPLACES = {
    "stem_fused": "argus_tpu/ops/pallas/stem_fused.py:244",
    "stage_fused": "argus_tpu/ops/pallas/stage_fused.py:527",
    "proj_fused": "argus_tpu/ops/pallas/proj_fused.py:205",
    "block_fused": "argus_tpu/ops/pallas/block_fused.py:270",
}
EXPECTED_LAUNCHES = {"stem_fused": 1, "stage_fused": 1, "proj_fused": 3, "block_fused": 10}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


GPU = ""


def say(msg: str) -> None:
    print(f"{msg}  [{GPU}]", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` back-to-back calls, CUDA events, one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ─────────────────────────── phase 1: build ───────────────────────────


def build_phase() -> None:
    from argus_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    took = _build.build()
    say(f"build: {len(took)} of {len(_build.SOURCES)} kernel libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name in _build.SOURCES:
        log = _build.log_path(name)
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")


# ─────────────────────────── phase 2: kernels ───────────────────────────


def _w(g, *shape):
    import torch

    fan_in = 1
    for s in shape[:-1]:
        fan_in *= s
    return (torch.randn(*shape, generator=g, device="cuda") / fan_in**0.5).to(torch.bfloat16)


def _b(g, c):
    import torch

    return 0.1 * torch.randn(1, c, generator=g, device="cuda")


def _id_weights(g, c, f):
    return (_w(g, c, f), _b(g, f), _w(g, 3, 3, f, f), _b(g, f), _w(g, f, c), _b(g, c))


def _proj_weights(g, cin, f, cout):
    return (_w(g, cin, f), _b(g, f), _w(g, 3, 3, f, f), _b(g, f), _w(g, f, cout), _b(g, cout),
            _w(g, cin, cout), _b(g, cout))


def _lib_conv(x, w, stride=1, padding=0):
    """cuDNN conv of an NHWC bf16 activation with an HWIO or (CIN, COUT)
    weight, in channels-last layout; returns NHWC bf16."""
    import torch
    import torch.nn.functional as F

    if w.ndim == 2:
        w = w.reshape(1, 1, *w.shape)
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x.permute(0, 3, 1, 2), wt, stride=stride, padding=padding).permute(0, 2, 3, 1)


def _lib_block(x, w1, b1, w2, b2, w3, b3, wsc=None, bsc=None, stride=1):
    import torch

    dt = x.dtype
    h1 = torch.relu(_lib_conv(x, w1) + b1.reshape(-1).to(dt))
    h2 = torch.relu(_lib_conv(h1, w2, stride, 1) + b2.reshape(-1).to(dt))
    y = _lib_conv(h2, w3) + b3.reshape(-1).to(dt)
    res = x if wsc is None else _lib_conv(x, wsc, stride) + bsc.reshape(-1).to(dt)
    return torch.relu(y + res)


def _block_flops(n, h, w, cin, f, cout, s, proj):
    ho, wo = h // s, w // s
    fl = 2 * n * (h * w * cin * f + ho * wo * (9 * f * f + f * cout))
    return fl + (2 * n * ho * wo * cin * cout if proj else 0)


def _round_trip_bytes(n, h, w, f, s):
    """Device-memory bytes a block's h1 (n, h, w, f) and h2 (n, h/s, w/s, f)
    cost today: each written once and read back once."""
    return 2 * BF * n * f * (h * w + (h // s) * (w // s))


def _compare(name, got, want) -> float:
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    if not (err <= TOL_REL * ref + TOL_ABS) or not got.isfinite().all():
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {TOL_REL} * {ref} + {TOL_ABS}")
    return err


def kernel_phase() -> dict:
    """Per-kernel check and timing at the serving shapes. Returns the
    measured entries keyed by kernel name; proj/block times are totals over
    the calls one predict makes (3 projection blocks, 3 + 5 + 2 identity
    blocks)."""
    import torch

    from argus_tpu_torch.ops.kernels import block_fused, proj_fused, stage_fused, stem_fused

    torch.backends.cudnn.allow_tf32 = False  # the plain f32 reference convs run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"kernel phase: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; library_ms is bf16 cuDNN")
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}

    def record(name, cases):
        """cases: [(label, count per predict, kernel fn, plain fn, library fn, flops,
        bytes, device kernels per call, intermediate round-trip bytes)]"""
        entry = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
        for label, count, kern, plain, lib, flops, nb, gemms, extra in cases:
            err = _compare(f"{name} {label}", kern(), plain())
            ms, pms, lms = cuda_ms(kern, 5), cuda_ms(plain, 2), cuda_ms(lib, 5)
            b, by = bound_ms(flops, nb)
            say(f"{name} {label} x{count}: max_abs_err {err:.4g}, kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                f"library {lms:.3f} ms, bound {b:.3f} ms ({by}), {flops / ms / 1e9:.1f} TFLOP/s, "
                f"{gemms} device kernels per call, intermediates {extra / 1e9:.2f} GB written and read back")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("flops", flops), ("bytes", nb)):
                entry[k] += count * v
        results[name] = entry

    # stem: (N, 256, 256, 3) -> (N, 64, 64, 64)
    x = torch.rand(N_IMG, HW, HW, 3, generator=g, device="cuda").to(torch.bfloat16)
    w7 = _w(g, 7, 7, 3, 64)
    b7 = _b(g, 64)
    out = stem_fused.stem_pool(x, w7, b7)

    def lib_stem():
        import torch.nn.functional as F

        y = torch.relu(_lib_conv(x, w7, 2, 3) + b7.reshape(-1).to(torch.bfloat16))
        return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

    record("stem_fused", [(
        f"{tuple(x.shape)}", 1, lambda: stem_fused.stem_pool(x, w7, b7),
        lambda: stem_fused.stem_pool_plain(x, w7, b7), lib_stem,
        2 * N_IMG * (HW // 2) ** 2 * 64 * 147, nbytes(x, w7, b7, out), 1, 0,
    )])
    del x, out

    # stage-0 chain: (N, 64, 64, 64) -> (N, 64, 64, 256)
    x0 = torch.rand(N_IMG, 64, 64, 64, generator=g, device="cuda").to(torch.bfloat16)
    p0 = _proj_weights(g, 64, 64, 256)
    ids0 = [_id_weights(g, 256, 64) for _ in range(2)]
    flops0 = _block_flops(N_IMG, 64, 64, 64, 64, 256, 1, True) + 2 * _block_flops(
        N_IMG, 64, 64, 256, 64, 256, 1, False)

    def lib_stage():
        y = _lib_block(x0, *p0[:6], p0[6], p0[7])
        for w in ids0:
            y = _lib_block(y, *w)
        return y

    out_bytes = N_IMG * 64 * 64 * 256 * BF
    record("stage_fused", [(
        f"{tuple(x0.shape)} F=64", 1, lambda: stage_fused.fused_stage(x0, p0, ids0, 1),
        lambda: stage_fused.stage_plain(x0, p0, ids0, 1), lib_stage,
        flops0, nbytes(x0, *p0, *[t for w in ids0 for t in w]) + out_bytes, 9,
        3 * _round_trip_bytes(N_IMG, 64, 64, 64, 1) + 2 * 2 * out_bytes,  # + 2 block boundaries
    )])
    del x0

    # stage 1-3 entries and identity blocks
    proj_cases, id_cases = [], []
    for i, (h, cin, f, n_id) in enumerate([(64, 256, 128, 3), (32, 512, 256, 5), (16, 1024, 512, 2)]):
        cout, ho = 4 * f, h // 2
        xp = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = _proj_weights(g, cin, f, cout)
        proj_cases.append((
            f"stage{i + 1} {tuple(xp.shape)} F={f}", 1,
            lambda xp=xp, pw=pw: proj_fused.projection_block(xp, *pw, 2),
            lambda xp=xp, pw=pw: proj_fused.projection_block_plain(xp, *pw, 2),
            lambda xp=xp, pw=pw: _lib_block(xp, *pw[:6], pw[6], pw[7], stride=2),
            _block_flops(N_IMG, h, h, cin, f, cout, 2, True),
            nbytes(xp, *pw) + N_IMG * ho * ho * cout * BF, 3,
            _round_trip_bytes(N_IMG, h, h, f, 2),
        ))
        xi = torch.rand(N_IMG, ho, ho, cout, generator=g, device="cuda").to(torch.bfloat16)
        iw = _id_weights(g, cout, f)
        id_cases.append((
            f"stage{i + 1} {tuple(xi.shape)} F={f}", n_id,
            lambda xi=xi, iw=iw: block_fused.bottleneck_block(xi, *iw),
            lambda xi=xi, iw=iw: block_fused.bottleneck_block_plain(xi, *iw),
            lambda xi=xi, iw=iw: _lib_block(xi, *iw),
            _block_flops(N_IMG, ho, ho, cout, f, cout, 1, False),
            2 * nbytes(xi) + nbytes(*iw), 3, _round_trip_bytes(N_IMG, ho, ho, f, 1),
        ))
    record("proj_fused", proj_cases)
    record("block_fused", id_cases)
    del proj_cases, id_cases
    torch.cuda.empty_cache()
    return results


# ─────────────────────────── phase 3: end to end ───────────────────────────


def _randomize_(model, seed: int) -> None:
    """Seeded random weights: lecun-normal convs and dense layers, BN scales,
    biases, means and variances all randomised (the last BN of each block at
    a smaller scale, so 16 residual blocks keep activations O(1)); the output
    layer gets a gain of 8 so the se(3) outputs, and the pose comparison,
    are O(1) rather than O(0.1)."""
    import torch

    from argus_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                lo, hi = (0.1, 0.3) if name.endswith("BatchNorm_2") else (0.5, 1.5)
                mod.weight.copy_(lo + (hi - lo) * torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
            elif hasattr(mod, "weight") and isinstance(mod.weight, torch.nn.Parameter):
                w = mod.weight
                fan_in = w[0].numel()
                gain = 8.0 if name == "head_out" else 1.0
                w.copy_(gain * torch.randn(w.shape, generator=g) / fan_in**0.5)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.copy_(0.01 * torch.randn(mod.bias.shape, generator=g))


def end_to_end_phase(tmpdir: str) -> tuple:
    import numpy as np
    import torch

    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.serve import Estimator

    cfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50")
    model = NCameraCNN(cfg)
    _randomize_(model, seed=0)
    params, stats = variables_from_state_dict(model.state_dict())
    ckpt = os.path.join(tmpdir, "resnet50_random.ckpt")
    meta = {"model_type": "pose_cnn", "model_config": dataclasses.asdict(cfg), "center_crop": [HW, HW]}
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats}, meta=meta)
    del model, params, stats

    t0 = time.perf_counter()
    est = Estimator(ckpt, batch_size=N_ROWS)
    say(f"end to end: Estimator(batch_size={N_ROWS}) on {est.device} built and warmed in "
        f"{time.perf_counter() - t0:.1f} s; config dtype={est.cfg.dtype}, fuse_stem={est.cfg.fuse_stem}, "
        f"fuse_stage={est.cfg.fuse_stage}")
    frames = np.random.default_rng(0).integers(0, 256, (N_ROWS, HW, HW, 6), dtype=np.uint8)

    kernels.reset_launch_counts()
    poses = est.predict(frames)
    launches = kernels.launch_counts()
    say(f"end to end: launches in one predict {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches} != expected {EXPECTED_LAUNCHES}")
    if poses.shape != (N_ROWS, 7) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"bad poses: shape {poses.shape}, finite {np.isfinite(poses).all()}")
    qnorm = np.linalg.norm(poses[:, 3:], axis=-1)
    if not np.allclose(qnorm, 1.0, atol=1e-2):
        raise AssertionError(f"quaternions not unit: {qnorm.min()}..{qnorm.max()}")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        est.predict(frames)
    ms = (time.perf_counter() - t0) / reps * 1e3
    say(f"end to end: {ms:.2f} ms per predict of {N_ROWS} rows = {N_ROWS / ms * 1e3:.1f} rows/s, "
        f"{N_IMG / ms * 1e3:.1f} camera-images/s (host clock, uint8 numpy in, poses numpy out)")
    # where a predict's time goes: the uint8 upload (host clock) and the
    # model forward on a resident batch (CUDA events)
    t0 = time.perf_counter()
    for _ in range(reps):
        on_card = torch.from_numpy(frames).to("cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) / reps * 1e3
    with torch.inference_mode():
        images = on_card.float() / 255.0
        forward_ms = cuda_ms(lambda: est.model(images), reps)
    say(f"end to end breakdown: uint8 upload {upload_ms:.2f} ms (pageable, {frames.nbytes / 1e6:.0f} MB), "
        f"model forward {forward_ms:.2f} ms on the card; together {upload_ms + forward_ms:.2f} ms "
        f"of the {ms:.2f} ms predict (separate runs, so the two may not add up exactly)")

    t0 = time.perf_counter()
    cpu = Estimator(ckpt, batch_size=8, device="cpu")
    ref = cpu.predict(frames[:8])
    err = float(np.abs(poses[:8] - ref).max())
    say(f"end to end: GPU vs CPU poses on the first 8 rows: max abs diff {err:.4g} (atol {POSE_ATOL}), "
        f"|pose| max {float(np.abs(ref).max()):.3g}, CPU estimator {time.perf_counter() - t0:.1f} s")
    if not err <= POSE_ATOL:
        raise AssertionError(f"GPU poses differ from the CPU estimator by {err} > {POSE_ATOL}")
    return launches, ms


def main() -> int:
    global GPU
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import argus_tpu_torch  # noqa: F401  (fails outside a checkout)

    GPU = gpu_line()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    build_phase()
    measured = kernel_phase()
    from argus_tpu_torch.ops.kernels import _build

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        launches, _ = end_to_end_phase(tmpdir)

    rows = []
    for name, m in measured.items():
        b, by = bound_ms(m["flops"], m["bytes"])
        rows.append({
            "name": name, "route": "cuda", "source": f"argus_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": b, "bound_by": by, "library_ms": m["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(GPU)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
