#!/usr/bin/env python3
"""Time the augmentation kernel (`csrc/augment_fused.cu`) and the stem
weight-gradient kernel (`csrc/stem_fused_bwd.cu`) phase by phase, at the
flagship step's shapes (512 camera images of 256x256, bf16), from builds
of their sources cut at the `#if` phase markers; count the instructions of
the augmentation kernel's instantiations.

    python3 scripts/time_torch_kernel_phases.py [--root DIR] [--only augment,stem,sass]

- augmentation (`AUG_CUT`, `AUG_NOHUE`): cut after the band's load and
  tables, after pass 2 (arcs, gains, ops before the contrast), after the
  reduction, pass 4 (contrast, ops after it, shade bits) and the halo copy;
  the rest is the blur; a build without the hue op; the full kernel with
  and without arcs;
- stem weight gradient (`STEM_NOSEARCH`, `STEM_NOMMA`, `STEM_XONLY`,
  `STEM_ONE_LEVEL`): without the product, the product alone (with all
  operands staged, and with only the patch staged), the loads alone, and
  the whole kernel with its partials added by one last block instead of
  the two-level tree;
- `sass`: the opcode counts of each `augment_kernel` instantiation
  (conversions F2F, packed bf16x2 ops).

`--root DIR` takes the sources and the package from an unpacked tree. The
builds go to a temporary directory under `argus_tpu_torch/_build/`
(gitignored) and load with ctypes. CUDA events over 20 calls after a
warm-up, twice each. Card only (exits without a CUDA device).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter

N, HW = 512, 256
VP, I = ctypes.c_void_p, ctypes.c_int


def nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(tmp: str, csrc: str, name: str, variants: dict) -> dict:
    """variants: tag -> list of -D macros; one nvcc each, in parallel."""
    path = os.path.join(csrc, f"{name}.cu")
    jobs = {}
    for tag, defs in variants.items():
        so = os.path.join(tmp, f"lib{name}_{re.sub(r'\W+', '_', tag)}.so")
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-I", csrc, *[f"-D{d}" for d in defs], "-o", so, path]
        jobs[tag] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(so)
    return libs


def event_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def augment(torch, tmp: str, csrc: str) -> None:
    from argus_tpu_torch.ops import augment as TA
    from argus_tpu_torch.ops.kernels import augment_fused as kaf

    names = ("load and tables", "+ pass 2", "+ reduction, pass 4 and halo")
    libs = build(tmp, csrc, "augment_fused", {"1": ["AUG_CUT=1"], "2": ["AUG_CUT=2"], "3": ["AUG_CUT=3"],
                                              "full": [], "nohue": ["AUG_NOHUE=1"]})
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(N, 3, HW, HW, generator=g, device="cuda").to(torch.bfloat16)
    p = TA.sample_params(TA.AugmentationConfig(), 11, N // 2, 2, HW, HW, "cuda", x.dtype)
    out = torch.empty_like(x)
    for n_arcs in (10, 0):
        q = p if n_arcs else TA.AugmentParams(**{**vars(p), "arcs": None})
        field, mh, mwt, packed, order = TA.pack_fused(q, N, HW, HW, n_arcs, "cuda")
        hue_pos, aff = kaf.jiggle_plan(order.reshape(4))
        plan = torch.cat([hue_pos[None], aff[0]]).contiguous()
        ranges = kaf.nonzero_ranges(mh, mwt)
        rc = kaf.chunk_rows(HW, HW, field.shape[-1], n_arcs, x.element_size())

        def call(lib):
            fn = lib.argus_augment_fused
            fn.argtypes = [VP] * 8 + [I] * 7 + [VP]
            err = fn(x.data_ptr(), field.data_ptr(), mh.data_ptr(), mwt.data_ptr(), packed.data_ptr(),
                     plan.data_ptr(), ranges.data_ptr(), out.data_ptr(), N, HW, HW, field.shape[-1], n_arcs, rc, 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"augment launch failed: {err}")

        for rnd in range(2):
            t = {k: event_ms(torch, lambda k=k: call(libs[k])) for k in ("1", "2", "3", "full", "nohue")}
            print(f"augment_fused bf16 {n_arcs} arcs order {order.tolist()[0]} run {rnd}: {names[0]} {t['1']:.4f} ms, "
                  f"{names[1]} {t['2']:.4f}, {names[2]} {t['3']:.4f}, full {t['full']:.4f} (rest "
                  f"{t['full'] - t['3']:.4f}); without the hue {t['nohue']:.4f}", flush=True)


def stem(torch, tmp: str, csrc: str) -> None:
    from argus_tpu_torch.ops.kernels import _build
    from argus_tpu_torch.ops.kernels import stem_fused as ks

    variants = {"full": [], "no product": ["STEM_NOMMA=1"], "product alone": ["STEM_NOSEARCH=1"],
                "product alone, patch only staged": ["STEM_NOSEARCH=1", "STEM_XONLY=1"],
                "loads alone": ["STEM_NOSEARCH=1", "STEM_NOMMA=1"], "one-level sum": ["STEM_ONE_LEVEL=1"]}
    libs = build(tmp, csrc, "stem_fused_bwd", variants)
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.rand(N, HW, HW, 3, generator=g, device="cuda").to(torch.bfloat16)
    w7 = (0.2 * torch.randn(7, 7, 3, 64, generator=g, device="cuda")).to(torch.bfloat16)
    b = 0.1 * torch.randn(1, 64, generator=g, device="cuda")
    out, y = ks.stem_fwd_save(x, w7, b)
    gr = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    dw = torch.empty((7, 7, 3, 64), device="cuda")
    for n_images in (N, N // 4):
        blocks, gsize = ks.bwd_grid(n_images * 64, torch.cuda.get_device_properties(0).multi_processor_count)
        ws = torch.empty((blocks + -(-blocks // gsize), 147, 64), device="cuda")
        tickets = _build.tickets(x)

        def call(lib):
            fn = lib.argus_stem_bwd
            fn.argtypes = [VP] * 7 + [I] * 5 + [VP]
            err = fn(x.data_ptr(), gr.data_ptr(), out.data_ptr(), y.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                     tickets.data_ptr(), n_images, HW, HW, blocks, gsize, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"stem backward launch failed: {err}")

        for rnd in range(2):
            t = {k: event_ms(torch, lambda k=k: call(libs[k])) for k in libs}
            print(f"stem_fused_bwd n_images {n_images} run {rnd}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()),
                  flush=True)


def sass(tmp: str, csrc: str) -> None:
    so = os.path.join(tmp, "libaugment_sass.so")
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-I", csrc, "-o", so, os.path.join(csrc, "augment_fused.cu")], check=True)
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    for f in re.split(r"\n\s+Function : ", text)[1:]:
        name = f.split("\n", 1)[0].strip()
        if "augment_kernel" not in name:
            continue
        ops = Counter(m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", f))
        conv = {k: v for k, v in ops.items() if k.startswith(("F2F", "F2FP", "I2F", "F2I"))}
        packed = {k: v for k, v in ops.items() if k.startswith(("HMUL2", "HADD2", "HFMA2", "HMNMX2", "HSET"))}
        widen = {k: ops.get(k, 0) for k in ("IMAD.U32", "SHF.L.U32", "PRMT")}
        print(f"sass {name}: {sum(ops.values())} instructions; conversions {sorted(conv.items())}; packed "
              f"{sorted(packed.items())}; shifts and permutes {widen}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--only", default="augment,stem,sass")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on the card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    csrc = os.path.join(root, "argus_tpu_torch", "csrc")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"(sources: {root})", flush=True)
    build_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "argus_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        for part in args.only.split(","):
            if part == "augment":
                augment(torch, tmp, csrc)
            elif part == "stem":
                stem(torch, tmp, csrc)
            elif part == "sass":
                sass(tmp, csrc)
            else:
                raise SystemExit(f"unknown part {part!r}")


if __name__ == "__main__":
    main()
