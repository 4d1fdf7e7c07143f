"""The port's tracing utilities (`argus_tpu_torch.profiling`): `profile_fn`
returns argus_tpu's statistics, and `trace` writes a Chrome trace that
names an `annotate` region."""

import gzip
import json

import torch

from argus_tpu_torch import profiling


def test_profile_fn_keys_and_order():
    calls = []

    def fn():
        calls.append(1)
        return {"out": torch.ones(4) * len(calls), "n": (torch.zeros(1),)}

    stats = profiling.profile_fn(fn, n_trials=5, warmup=1)
    assert set(stats) == {"mean_ms", "p50_ms", "p95_ms", "n_trials"}
    assert stats["n_trials"] == 5 and len(calls) == 6
    assert 0.0 <= stats["p50_ms"] <= stats["p95_ms"] and stats["mean_ms"] >= 0.0


def test_trace_writes_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "run"), create_perfetto_trace=True) as log_dir:
        with profiling.annotate("train_step"):
            torch.relu(torch.randn(64, 64)).sum().item()
    assert log_dir == str(tmp_path / "run")
    with open(tmp_path / "run" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)
    with gzip.open(tmp_path / "run" / profiling.PERFETTO_FILE) as f:
        assert any(e.get("name") == "train_step" for e in json.load(f)["traceEvents"])
