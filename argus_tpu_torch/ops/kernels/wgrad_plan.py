"""The work plan of the Hopper weight-gradient engine (`csrc/wgrad_sm90.cuh`,
`wg90_plan`), mirrored here to size the workspace of its partials; the
CPU tests (`tests/test_torch_wgrad_plan.py`) check that the plan covers the
work exactly once.

One weight gradient dW[tap, c, n] = sum_m A_tap[m, c] * B[m, n] over M
pixel rows is cut into:
- jobs of 64 source channels x `taps_per_job` taps, each for one n block of
  `bn` gradient channels: the three kx of one ky row of a 3x3 over an odd
  count of 64-channel blocks (one block per SM, 64 wide), else one tap
  (two blocks per SM, 128 wide where the job count is even);
- blocks of two warpgroups: two jobs on the same rows, or, where the job
  count is odd (`rowsplit`), one job on the two 64-row halves of each
  128-row step, each half writing its own partial;
- `splits` contiguous row ranges of `steps_per_split` steps, the count
  chosen so that the blocks fill the last of at most four waves (132 *
  `minb` blocks each on the H100) best (the first of equally good counts),
  with at least 16 steps a split.

`parts` = splits * (1 + rowsplit) partials of (taps, C, COUT) f32 are added
in order by a second pass when there is more than one.

Used by the block backwards `basic_fused.basic_bwd`, `proj_fused.proj_bwd`,
`block_fused.block_bwd` and `block_fused.block_bwd_recompute`, by the
stage chain's `stage_fused.stage_bwd` (over every block's plans,
`stage_fused.chain_wgrad_plans`) and by the pointwise backward
`pointwise.pointwise_bwd` (one launch: M rows, CIN, COUT, one tap). Only
the previous forms timed beside them keep the older engine (`csrc/wgrad.cuh`,
sized by `bwd_prev.wgrad_workspace`).
"""

from __future__ import annotations

from dataclasses import dataclass

SMS = 132  # the H100 SXM's SMs
MAX_WAVES = 4  # splits stop at this many waves
MIN_STEPS = 16  # steps a split reduces at least


@dataclass(frozen=True)
class Plan:
    taps_per_job: int
    bn: int
    rowsplit: int
    minb: int  # blocks resident on one SM
    cblocks: int
    jobs: int
    units: int  # blocks of one split of one n block
    nblocks: int
    splits: int
    steps_per_split: int
    parts: int
    partial_elems: int  # f32 the partials take (0 when parts == 1)

    @property
    def rows_per_step(self) -> int:
        return 64 * (1 + self.rowsplit)

    @property
    def blocks(self) -> int:
        return self.units * self.splits * self.nblocks


def plan(rows: int, c: int, cout: int, ks: int) -> Plan:
    """`wg90_plan` of csrc/wgrad_sm90.cuh for M = rows, C = c, COUT = cout
    and a ks x ks kernel (1 or 3)."""
    if ks not in (1, 3):
        raise ValueError(f"kernel size must be 1 or 3, got {ks}")
    taps = ks * ks
    cblocks = -(-c // 64)
    three = ks == 3 and cblocks % 2 == 1
    taps_per_job = 3 if three else 1
    minb = 1 if three else 2
    jobs = cblocks * (taps // taps_per_job)
    rowsplit = jobs % 2
    bn = 64 if (three or rowsplit or cout <= 64) else 128
    units = jobs if rowsplit else jobs // 2
    nblocks = -(-cout // bn)
    step_rows = 64 * (1 + rowsplit)
    steps = -(-rows // step_rows)
    tiles = units * nblocks
    slots = SMS * minb  # blocks in one wave
    most = min(max(1, steps // MIN_STEPS), max(1, (MAX_WAVES * slots) // tiles))
    best, best_eff = 1, -1.0
    for s in range(1, most + 1):
        blocks = tiles * s
        eff = blocks / (-(-blocks // slots) * slots)
        if eff > best_eff + 1e-9:
            best, best_eff = s, eff
    sps = -(-steps // best)
    splits = max(1, -(-steps // sps))
    sps = max(1, sps)
    parts = splits * (1 + rowsplit)
    return Plan(taps_per_job, bn, rowsplit, minb, cblocks, jobs, units, nblocks, splits, sps, parts,
                parts * taps * c * cout if parts > 1 else 0)


def workspace(*problems) -> int:
    """f32 elements of partials the weight-gradient launches of one backward
    need, for problems (rows, C, COUT, ks): the largest `partial_elems`,
    since the launches run one after another on one stream."""
    return max((plan(*prob).partial_elems for prob in problems), default=0)
