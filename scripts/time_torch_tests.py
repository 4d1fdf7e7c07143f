#!/usr/bin/env python3
"""What the port's CPU tests cost: each test file run alone, one after the
other, each in a pytest process of its own.

    python3 scripts/time_torch_tests.py [--root DIR] [--split] [--kernels] [--together] [FILE ...]

With no FILE it runs the port's heaviest files (`HEAVY` below). Prints, per
file, the wall seconds and the CPU seconds (user + system of the pytest
process and every process it waited for, from `getrusage(RUSAGE_CHILDREN)`:
the tier-1 suite runs six workers on a shared host, so its time follows the
CPU seconds more than one file's wall time), the counts of passed, failed and
skipped cases, and each file's five slowest cases (junit `time`: call and
fixtures). `--root` runs the tests of another checkout (an unpacked commit)
so two trees can be timed on one host. `--split` also times, within each
listed case, the port's side: `argus_tpu_torch.train.create_train_state` and
every call of a step that `make_train_step` returned (wrapped before the
tests are collected); the rest of a whole-step parity case is argus_tpu's
reference (its trace, compile and run) and the comparison. `--kernels`
lists, per listed case, the argus_tpu functions that called
`pl.pallas_call` while the case ran (`file:function`), that is which of
argus_tpu's Pallas kernels it traced (a function jit-compiled by an earlier
case is not traced again). `--together` runs the files in one pytest
command with the tier-1 suite's workers (`-n 6 --dist loadfile`) instead,
for the CPU seconds of the files as the suite runs them, which the suite's
own output does not report. Runs on the CPU (`JAX_PLATFORMS=cpu`); needs no
card.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAVY = [
    "tests/test_torch_train.py",
    "tests/test_torch_train_bn.py",
    "tests/test_torch_pointwise.py",
    "tests/test_torch_serve.py",
    "tests/test_torch_keypoint.py",
    "tests/test_torch_resident.py",
    "tests/test_torch_remat.py",
    "tests/test_torch_dp.py",
    "tests/test_torch_frozen.py",
    "tests/test_torch_loop.py",
    "tests/test_torch_export.py",
]
TOP = 5  # slowest cases listed per file


# loaded into the pytest process by `--split` / `--kernels`: wall seconds of
# the port's state creation and train steps, and the Pallas kernels traced,
# per test, written to $TIME_TORCH_SPLIT
_SPLIT_PLUGIN = """
import json, os, sys, time

_spent, _now = {}, [None]


def _timed(fn, what):
    def call(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            if _now[0] is not None:
                d = _spent.setdefault(_now[0], {})
                d[what] = d.get(what, 0.0) + time.perf_counter() - t0
    return call


def _traced(call):
    def spy(*a, **k):
        f = sys._getframe(1).f_code
        if _now[0] is not None:
            kernels = _spent.setdefault(_now[0], {}).setdefault("kernels", [])
            name = os.path.basename(f.co_filename) + ":" + f.co_name
            if name not in kernels:
                kernels.append(name)
        return call(*a, **k)
    return spy


def pytest_configure(config):
    if os.environ.get("TIME_TORCH_KERNELS"):
        from jax.experimental import pallas as pl

        pl.pallas_call = _traced(pl.pallas_call)
    if os.environ.get("TIME_TORCH_PORT"):
        import argus_tpu_torch.train as T

        make_step = T.make_train_step
        T.create_train_state = _timed(T.create_train_state, "port_init_s")
        T.make_train_step = lambda *a, **k: _timed(make_step(*a, **k), "port_step_s")


def pytest_runtest_protocol(item, nextitem):
    _now[0] = item.name


def pytest_sessionfinish(session):
    with open(os.environ["TIME_TORCH_SPLIT"], "w") as f:
        json.dump(_spent, f)
"""


def _cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime


def time_file(root: str, path, split: bool = False, kernels: bool = False) -> dict:
    """Run one test file alone (or a list of them together, as the suite
    runs them); its wall and CPU seconds, counts and slowest cases."""
    paths = [path] if isinstance(path, str) else list(path)
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "junit.xml")
        cmd = [sys.executable, "-m", "pytest", *paths, "-q", "-m", "not slow", "-p", "no:cacheprovider",
               "-p", "no:randomly", f"--junitxml={xml}"]
        if not isinstance(path, str):
            cmd += ["-p", "xdist", "-n", "6", "--dist", "loadfile"]
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        env["TIME_TORCH_SPLIT"] = os.path.join(tmp, "split.json")
        if split or kernels:
            with open(os.path.join(tmp, "time_torch_split.py"), "w") as f:
                f.write(_SPLIT_PLUGIN)
            cmd += ["-p", "time_torch_split"]
            env["PYTHONPATH"] = os.pathsep.join([tmp, root] + [p for p in [env.get("PYTHONPATH")] if p])
            env.update({k: "1" for k, on in (("TIME_TORCH_PORT", split), ("TIME_TORCH_KERNELS", kernels)) if on})
        cpu0, t0 = _cpu_seconds(), time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        wall, cpu = time.perf_counter() - t0, _cpu_seconds() - cpu0
        cases, counts = [], {"passed": 0, "failed": 0, "skipped": 0}
        if os.path.exists(xml):
            for tc in ET.parse(xml).getroot().iter("testcase"):
                kinds = {c.tag for c in tc}
                kind = "failed" if kinds & {"failure", "error"} else "skipped" if "skipped" in kinds else "passed"
                counts[kind] += 1
                cases.append((float(tc.get("time", 0.0)), tc.get("name")))
        spent = {}
        if os.path.exists(env["TIME_TORCH_SPLIT"]):
            with open(env["TIME_TORCH_SPLIT"]) as f:
                spent = json.load(f)
    cases.sort(reverse=True)
    return {"file": path if isinstance(path, str) else f"{len(paths)} files together", "rc": proc.returncode, "wall_s": wall, "cpu_s": cpu, **counts,
            "slowest": [{"name": n, "s": s, **spent.get(n, {})} for s, n in cases[:TOP]],
            "tail": proc.stdout[-2000:] if proc.returncode else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*", help="test files, relative to --root (default: the heavy port files)")
    ap.add_argument("--root", default=REPO, help="checkout whose tests run (default: this one)")
    ap.add_argument("--split", action="store_true", help="time the port's side within each listed case")
    ap.add_argument("--kernels", action="store_true", help="list the argus_tpu Pallas kernels each case traced")
    ap.add_argument("--together", action="store_true", help="run the files together, as the tier-1 suite does")
    args = ap.parse_args(argv)
    files = args.files or HEAVY
    rows = []
    for path in [files] if args.together else files:
        row = time_file(os.path.abspath(args.root), path, args.split, args.kernels)
        rows.append(row)
        print(f"{row['file']}: wall {row['wall_s']:.1f} s, cpu {row['cpu_s']:.1f} s, "
              f"{row['passed']} passed, {row['failed']} failed, {row['skipped']} skipped, rc {row['rc']}",
              flush=True)
        for c in row["slowest"]:
            port = c.get("port_init_s", 0.0) + c.get("port_step_s", 0.0)
            side = f"  (port {port:.2f} s: init {c.get('port_init_s', 0.0):.2f}, steps {c.get('port_step_s', 0.0):.2f})"
            print(f"    {c['s']:8.2f} s  {c['name']}{side if args.split else ''}", flush=True)
            if args.kernels:
                print(f"               Pallas: {', '.join(c.get('kernels', [])) or 'none'}", flush=True)
        if row["rc"]:
            print(row["tail"], flush=True)
    wall, cpu = sum(r["wall_s"] for r in rows), sum(r["cpu_s"] for r in rows)
    print(f"total: wall {wall:.1f} s, cpu {cpu:.1f} s, {sum(r['passed'] for r in rows)} passed")
    return 1 if any(r["rc"] not in (0, 5) for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
