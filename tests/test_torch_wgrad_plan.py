"""The work plan of the Hopper weight-gradient engine (`csrc/wgrad_sm90.cuh`
`wg90_plan`, mirrored by `argus_tpu_torch.ops.kernels.wgrad_plan`), on the
CPU: every (tap, source channel, gradient channel, pixel row) of a weight
gradient is reduced by exactly one warpgroup of the launch, each partial
region is written once, the split rule keeps its limits, and the workspace
the wrappers allocate holds every partial the launches write. The problems
are those of the eleven main-path geometries (the keypoint step's
BasicBlocks, the flagship's stride-2 projection blocks and its identity
bottlenecks at N = 512, 256x256 frames), of configuration P's twelve
pointwise convs and an odd M, and of the card tests
(`tests/test_torch_cuda.py`); the identity block's plans follow the launch
order of `csrc/identity_bwd_sm90.cuh`, the pointwise backward's its launch
in `csrc/pointwise_bwd.cu`.
"""

import re
from pathlib import Path

import pytest

from argus_tpu_torch.ops.kernels import wgrad_plan
from argus_tpu_torch.ops.kernels.block_fused import identity_wgrad_plans
from argus_tpu_torch.ops.kernels.pointwise import pointwise_wgrad_plans
from argus_tpu_torch.ops.kernels.proj_fused import projection_wgrad_plans

N_IMG = 512


def _basic(n, h, w, c):
    return [(n * h * w, c, c, 3)]  # dw1 and dw2: the same problem


def _proj(n, h, w, cin, f, cout, s):
    return projection_wgrad_plans(n, h, w, cin, f, cout, s)


# (H = W, CIN, F) of ResNet-50's identity bottlenecks, stages 0-3
IDENTITY_MAIN = [(64, 256, 64), (32, 512, 128), (16, 1024, 256), (8, 2048, 512)]
# the identity and recompute backwards' card cases (n, h, w, cin, f)
IDENTITY_CARD = [(2, 9, 7, 64, 16), (2, 48, 48, 64, 16), (1, 8, 8, 256, 64), (3, 5, 11, 128, 32),
                 (1, 5, 7, 2048, 512), (4, 32, 32, 256, 64), (2, 6, 5, 72, 24)]


MAIN = sorted({
    *[p for c, h in [(64, 64), (128, 32), (256, 16), (512, 8)] for p in _basic(N_IMG, h, h, c)],
    *[p for h, cin, f in [(64, 256, 128), (32, 512, 256), (16, 1024, 512)] for p in _proj(N_IMG, h, h, cin, f, 4 * f, 2)],
    *[p for h, cin, f in IDENTITY_MAIN for p in identity_wgrad_plans(N_IMG, h, h, cin, f)],
})
CARD = sorted({
    *[p for n, h, w, c in [(2, 9, 7, 64), (2, 48, 48, 64), (1, 8, 8, 256), (3, 5, 11, 128), (2, 7, 9, 256),
                           (1, 5, 7, 512), (4, 32, 32, 128)] for p in _basic(n, h, w, c)],
    *[p for n, h, w in [(2, 10, 6), (4, 32, 32)] for cin, f, cout in [(64, 32, 128), (256, 64, 256), (256, 128, 512)]
      for s in (1, 2) for p in _proj(n, h, w, cin, f, cout, s)],
    *[p for shape in IDENTITY_CARD for p in identity_wgrad_plans(*shape)],
})
CARD = [p for p in CARD if p not in MAIN]
# configuration P's pointwise convs (H = W, CIN, COUT): Conv_0 and Conv_2 of
# ResNet-50's bottlenecks, at n images
P_GEOMETRIES = [(64, 64, 64), (64, 256, 64), (64, 64, 256), (64, 256, 128), (32, 512, 128), (32, 128, 512),
                (32, 512, 256), (16, 1024, 256), (16, 256, 1024), (16, 1024, 512), (8, 2048, 512), (8, 512, 2048)]


def _pointwise(n):
    """The pointwise backward's plans at configuration P's twelve geometries
    over n images, and at an odd M of (n + 1) images of 7 x 7 (CIN 256,
    COUT 64)."""
    return [p for h, cin, cout in P_GEOMETRIES for p in pointwise_wgrad_plans(n * h * h, cin, cout)] + \
        pointwise_wgrad_plans((n + 1) * 7 * 7, 256, 64)


POINTWISE = sorted({p for p in _pointwise(N_IMG) + _pointwise(2) if p not in MAIN and p not in CARD})


def work_items(p, rows: int, c: int, cout: int, ks: int):
    """Every (block, warpgroup) of the launch as `wgrad_sm90_kernel` decodes
    it: yields (partial, taps, c range, n range, row ranges) of what that
    warpgroup reduces and where it writes."""
    taps = ks * ks
    step_rows = p.rows_per_step
    for bid in range(p.blocks):
        unit = bid % p.units
        rest = bid // p.units
        split = rest % p.splits
        n0 = (rest // p.splits) * p.bn
        mbeg = split * p.steps_per_split * step_rows
        mend = min(rows, mbeg + p.steps_per_split * step_rows)
        for wg in range(2):
            job = unit if p.rowsplit else unit * 2 + wg
            cb, tg = job % p.cblocks, job // p.cblocks
            tap_range = range(tg * p.taps_per_job, (tg + 1) * p.taps_per_job)
            assert tap_range.stop <= taps
            if p.rowsplit:  # this warpgroup's 64-row half of every step
                row_ranges = [range(r + wg * 64, min(r + wg * 64 + 64, mend)) for r in range(mbeg, mend, step_rows)]
            else:
                row_ranges = [range(mbeg, mend)]
            part = split * 2 + wg if p.rowsplit else split
            yield (part, tap_range, range(cb * 64, min(cb * 64 + 64, c)), range(n0, min(n0 + p.bn, cout)),
                   [r for r in row_ranges if len(r)])


def _ids(problems):
    return [f"M{m}-C{c}-N{n}-k{k}" for m, c, n, k in problems]


@pytest.mark.parametrize("rows,c,cout,ks", MAIN + CARD + POINTWISE, ids=_ids(MAIN + CARD + POINTWISE))
def test_plan_covers_every_tap_channel_and_row_once(rows, c, cout, ks):
    p = wgrad_plan.plan(rows, c, cout, ks)
    taps = ks * ks
    rows_of = {}  # (tap, c block, n block) -> row ranges reduced
    written = set()  # (part, tap, c block, n block)
    for part, tap_range, c_range, n_range, row_ranges in work_items(p, rows, c, cout, ks):
        assert 0 <= part < p.parts
        assert len(c_range) > 0 and len(n_range) > 0
        for tap in tap_range:
            key = (part, tap, c_range.start, n_range.start)
            assert key not in written, f"partial region {key} written twice"
            written.add(key)
            rows_of.setdefault((tap, c_range.start, n_range.start), []).extend(row_ranges)
    assert len(rows_of) == taps * p.cblocks * p.nblocks
    for key, ranges in rows_of.items():
        ranges = sorted((r.start, r.stop) for r in ranges)
        pos = 0
        for start, stop in ranges:
            assert start == pos, f"{key}: rows {pos}..{start} missed or overlapped"
            pos = stop
        assert pos == rows, f"{key}: rows {pos}..{rows} missed"
    # every channel block and n block of every tap is there, and nothing past C / COUT
    assert {k[1] for k in rows_of} == set(range(0, c, 64))
    assert {k[2] for k in rows_of} == set(range(0, cout, p.bn))


@pytest.mark.parametrize("rows,c,cout,ks", MAIN + CARD + POINTWISE, ids=_ids(MAIN + CARD + POINTWISE))
def test_plan_keeps_its_limits(rows, c, cout, ks):
    p = wgrad_plan.plan(rows, c, cout, ks)
    slots = wgrad_plan.SMS * p.minb
    assert p.splits == 1 or p.blocks <= wgrad_plan.MAX_WAVES * slots
    assert p.splits == 1 or p.steps_per_split >= wgrad_plan.MIN_STEPS
    assert (p.splits - 1) * p.steps_per_split * p.rows_per_step < rows <= p.splits * p.steps_per_split * p.rows_per_step
    assert p.parts == p.splits * (1 + p.rowsplit)
    assert p.partial_elems == (p.parts * ks * ks * c * cout if p.parts > 1 else 0)
    # the tile shapes the kernel is instantiated for
    assert (p.taps_per_job, p.bn, p.rowsplit, p.minb) in {(3, 64, 1, 1), (1, 64, 0, 2), (1, 64, 1, 2), (1, 128, 0, 2)}


@pytest.mark.parametrize("geometry", ["basic", "projection", "identity", "pointwise"])
@pytest.mark.parametrize("shape", [(N_IMG, 64, 64, 64), (N_IMG, 8, 8, 512), (2, 9, 7, 64), (4, 32, 32, 128)])
def test_workspace_holds_every_launch(geometry, shape):
    """The wrappers' workspace (the largest partial set of the backward's
    weight gradients) holds what each of its launches writes, and the main
    path's stays within a few tens of MB. The pointwise backward's: each of
    its one launch at configuration P's twelve geometries and the odd M over
    the shape's n images (N = 512: P's step and chip_smoke.py's 513 x 7 x 7),
    each sized on its own."""
    n, h, w, c = shape
    if geometry == "pointwise":
        for prob in _pointwise(n):
            ws = wgrad_plan.workspace(*pointwise_wgrad_plans(*prob[:3]))
            assert wgrad_plan.plan(*prob).partial_elems <= ws and ws * 4 < 256 * 2**20
        return
    if geometry == "basic":
        problems = _basic(n, h, w, c)
    elif geometry == "identity":
        problems = identity_wgrad_plans(n, h, w, 4 * c, c)
    else:
        problems = _proj(n, h, w, c, c // 2, 2 * c, 2 if h % 2 == 0 and w % 2 == 0 else 1)
    ws = wgrad_plan.workspace(*problems)
    for prob in problems:
        assert wgrad_plan.plan(*prob).partial_elems <= ws
    assert ws * 4 < 256 * 2**20


def test_main_path_plans_fill_whole_waves():
    """At the eleven geometries (the identity block's four included) the
    split rule fills at least 90% of the last wave of blocks."""
    for rows, c, cout, ks in MAIN:
        p = wgrad_plan.plan(rows, c, cout, ks)
        slots = wgrad_plan.SMS * p.minb
        waves = -(-p.blocks // slots)
        assert p.blocks / (waves * slots) >= 0.9, (rows, c, cout, ks, p)


@pytest.mark.parametrize("n,h,w,cin,f", [(N_IMG, h, h, cin, f) for h, cin, f in IDENTITY_MAIN] + IDENTITY_CARD)
def test_identity_plans_follow_the_kernel_launches(n, h, w, cin, f):
    """`identity_wgrad_plans` lists the weight-gradient launches of
    `identity_block_bwd_m3_sm90` (which `identity_block_bwd_sm90` runs after
    its mask pass) in its order, each with its rows, source channels,
    gradient channels and kernel size (wgrad_sm90(a, H, W, C, ks, stride,
    pad, b, COUT, N, Ho, Wo, ...), read from the header), so the workspace
    the wrappers allocate is sized by what the kernel launches."""
    src = (Path(wgrad_plan.__file__).resolve().parents[2] / "csrc" / "identity_bwd_sm90.cuh").read_text()
    body = src[src.index("inline cudaError_t identity_block_bwd_m3_sm90("):]
    dims = {"N": n, "H": h, "W": w, "CIN": cin, "F": f}
    launches = []
    for args in re.findall(r"wgrad_sm90\(([^;]*)\);", body):
        a = [t.strip() for t in args.split(",")]
        c, ks, cout, rows = dims[a[3]], int(a[4]), dims[a[8]], dims[a[9]] * dims[a[10]] * dims[a[11]]
        assert (a[5], a[6]) == ("1", "0" if ks == 1 else "1")  # stride 1, "same" padding
        launches.append((rows, c, cout, ks))
    assert launches == identity_wgrad_plans(n, h, w, cin, f)


@pytest.mark.parametrize("m,cin,cout", [(N_IMG * 64 * 64, 64, 256), (513 * 7 * 7, 256, 64), (49, 512, 2048)])
def test_pointwise_plans_follow_the_kernel_launch(m, cin, cout):
    """`pointwise_wgrad_plans` lists the `wgrad_sm90(` launch of
    csrc/pointwise_bwd.cu (M rows as N = M images of 1 x 1, one tap over
    x2 and m), so the workspace the wrapper allocates is sized by what the
    kernel launches."""
    src = (Path(wgrad_plan.__file__).resolve().parents[2] / "csrc" / "pointwise_bwd.cu").read_text()
    dims = {"M": m, "CIN": cin, "COUT": cout, "1": 1}
    launches = []
    for args in re.findall(r"wgrad_sm90\(([^;]*)\);", src):
        a = [t.strip() for t in args.split(",")]
        assert (a[1], a[2], a[5], a[6]) == ("1", "1", "1", "0")  # 1 x 1 source pixels, stride 1, no padding
        launches.append((dims[a[9]] * dims[a[10]] * dims[a[11]], dims[a[3]], dims[a[8]], int(a[4])))
    assert launches == pointwise_wgrad_plans(m, cin, cout)


def test_mirror_constants_match_the_kernel_header():
    src = (Path(wgrad_plan.__file__).resolve().parents[2] / "csrc" / "wgrad_sm90.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWgSms") == wgrad_plan.SMS
    assert const("kWgMaxWaves") == wgrad_plan.MAX_WAVES
    assert const("kWgMinSteps") == wgrad_plan.MIN_STEPS
