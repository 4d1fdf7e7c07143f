"""The port's multi-process dry-run (`argus_tpu_torch.dryrun`), the twin of
argus_tpu's `dryrun_multichip`, on 2 gloo processes on the CPU: its four
phases (the (data, model) grid with a model axis of 2, pure DP with the
flagship family at frozen BN, the fused backbone at `frozen_stages=0`, the
resident whole-epoch program) each print their OK line."""

import pytest
import torch

from argus_tpu_torch.dryrun import dryrun_multichip
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2, timeout=400)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 4, lines
    assert "mesh=data1xmodel2" in lines[0] and "head_fc1.weight" in lines[0]
    assert "DP mesh=data2, frozen-BN" in lines[1]
    assert "FUSED backbone" in lines[2]
    assert "RESIDENT whole-epoch mesh=data2, 2 batches/epoch" in lines[3]
