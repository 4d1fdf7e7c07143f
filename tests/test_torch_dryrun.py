"""The port's multi-process dry-run (`argus_tpu_torch.dryrun`), the twin of
argus_tpu's `dryrun_multichip`, on 2 gloo processes on the CPU: its four
phases (the (data, model) grid with a model axis of 2, pure DP with the
flagship family at frozen BN, the fused backbone at `frozen_stages=0`, the
resident whole-epoch program) each print their OK line."""

import pytest
import torch

from argus_tpu_torch.dryrun import dryrun_multichip


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process while the module runs (the suite's
    workers share the machine's cores with this file's rank processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2, timeout=400)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 4, lines
    assert "mesh=data1xmodel2" in lines[0] and "head_fc1.weight" in lines[0]
    assert "DP mesh=data2, frozen-BN" in lines[1]
    assert "FUSED backbone" in lines[2]
    assert "RESIDENT whole-epoch mesh=data2, 2 batches/epoch" in lines[3]
