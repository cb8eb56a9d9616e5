"""The bf16 RNN head's launch plans on the CPU: the tensor-core walk of K1
bf16 and K10 bf16 (csrc/rnn_cluster.cuh's tc_walk_kernel) and K10 bf16's
dW product (csrc/bf16_gemm.cuh), its scratch, and the plain model of the
shifted operand that dW reads. The kernels run only on the card
(chip_smoke.py); here their index arithmetic is replayed in Python."""

import numpy as np
import pytest
import torch

from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import fused_rnn as FR

BF = torch.bfloat16
BATCHES = (1, 3, 17, 64, 256, 1000)
# (H, direction): K1 bf16 at the model's 512 and a narrow 256 (H / 8 a
# multiple of 32), K10 bf16 at 512 and a narrow 40 (32 columns a block)
WIDTHS = ((512, "fwd"), (256, "fwd"), (512, "bwd"), (40, "bwd"))


def _w_registers(cols):
    """32-bit registers a thread of the bf16 walk keeps of W's slice: the
    mma's A fragments of its warp's 64-deep slice, 4 a 16 x 16 piece
    (tc_walk_kernel's wa)."""
    return (cols // 16) * (64 // 16) * 4


def _plan(B, H, direction):
    if direction == "fwd":
        return FR.fused_rnn_plan(B, H, 2)
    return FR.fused_rnn_bwd_plan(B, 40, H, 2).walk


@pytest.mark.parametrize("H,direction", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_bf16_walk_plan_covers_every_row_and_column_once(B, H, direction):
    """Every batch row lies in one cluster's tile, every column in one
    block, every depth entry in one warp's 64-deep slice; the mma's output
    fragments of a warp and the epilogue's threads each cover the block's
    (column, tile row) outputs once; shared memory and the W fragments a
    thread keeps fit, and the fragments hold W's slice whole."""
    plan = _plan(B, H, direction)
    bt, cols = plan.batch_tile, plan.cols
    rows = [c * bt + i for c in range(plan.clusters) for i in range(bt)]
    assert sorted(r for r in rows if r < B) == list(range(B))
    assert len(rows) - B < bt                   # one partial tile at most
    columns = [r * cols + j for r in range(plan.cluster)
               for j in range(cols)]
    assert sorted(c for c in columns if c < H) == list(range(H))
    assert plan.cluster * cols - H < cols or cols == 32
    depth = [64 * k + i for k in range(FR.RNN_SPLITS) for i in range(64)]
    assert depth == list(range(FR.TC_DEPTH)) and H <= FR.TC_DEPTH
    # a warp's C fragments (16 x 8 pieces: column tile mt, batch tile nb;
    # register r of lane (g, q) at column 16 mt + g + 8 (r >= 2), row 8 nb
    # + 2 q + r % 2), as tc_walk_kernel writes its partial sums
    n_tiles = FR.tc_rows(bt) // 8
    assert FR.tc_rows(bt) >= bt and n_tiles <= 4
    assert bt == min(-(-B // FR.TC_CLUSTERS), FR.TC_MAX_TILE)
    assert plan.clusters <= FR.TC_CLUSTERS or bt == FR.TC_MAX_TILE
    frag = [(16 * mt + g + 8 * (r >> 1), 8 * nb + 2 * q + (r & 1))
            for mt in range(cols // 16) for nb in range(n_tiles)
            for lane in range(32) for g, q in [(lane >> 2, lane & 3)]
            for r in range(4)]
    assert sorted(frag) == [(m, n) for m in range(cols)
                            for n in range(8 * n_tiles)]
    # the epilogue: quad qd < bt cols / 4 (thread qd % 256, its quad qd //
    # 256 of at most two) takes row qd / (cols / 4), columns 4 (qd % (cols /
    # 4)) .. + 3; lanes qd and qd ^ 1 hold eight columns, one 16-byte store
    quads = bt * cols // 4
    per_thread = -(-FR.tc_rows(bt) * cols // 4 // FR.RNN_THREADS)
    assert quads <= per_thread * FR.RNN_THREADS and per_thread <= 2
    assert quads % 2 == 0
    outs = [(qd // (cols // 4), 4 * (qd % (cols // 4)) + i)
            for qd in range(quads) for i in range(4)]
    assert sorted(outs) == [(n, m) for n in range(bt) for m in range(cols)]
    assert all((4 * (qd % (cols // 4))) % 8 == 4 * (qd % 2)
               for qd in range(quads))
    assert plan.smem_bytes == FR.tc_smem_bytes(cols, bt, direction == "bwd")
    assert plan.smem_bytes <= FR.MAX_SMEM and plan.smem_bytes % 16 == 0
    assert _w_registers(cols) <= 64
    assert FR.RNN_THREADS * 4 * _w_registers(cols) == \
        2 * cols * FR.TC_DEPTH


@pytest.mark.parametrize("B,T,H", [(1, 40, 512), (3, 40, 512),
                                   (64, 40, 512), (256, 40, 512),
                                   (1000, 40, 512), (3, 7, 40)])
def test_k10_bf16_dw_plan_covers_h_by_h_in_an_order_of_the_shapes(B, T, H):
    """dW's product tiles cover the H x H result, its splits the B T rows
    in whole 64-deep slices, one cluster of at most 16 blocks; the plan is
    a function of the shapes alone, so the order of the split sums is
    too."""
    plan = FR.fused_rnn_bwd_plan(B, T, H, 2)
    bm, bn = plan.dw_tile
    cover = {(i, j) for i0 in range(0, H, bm) for j0 in range(0, H, bn)
             for i in range(i0, min(i0 + bm, H))
             for j in range(j0, min(j0 + bn, H))}
    assert len(cover) == H * H
    assert plan.dw_rows % 64 == 0
    chunks = [(s * plan.dw_rows, min(B * T, (s + 1) * plan.dw_rows))
              for s in range(plan.dw_splits)]
    assert chunks[0][0] == 0 and chunks[-1][1] == B * T
    assert all(a < b for a, b in chunks)
    assert all(x[1] == y[0] for x, y in zip(chunks, chunks[1:]))
    assert 1 <= plan.dw_splits <= 16 and (bm == 64 or plan.dw_splits == 1)
    assert FR.fused_rnn_bwd_plan(B, T, H, 2) == plan


class _FakeLib:
    """A stand-in for the built library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("dtype,B,T,H", [(BF, 4, 40, 64), (BF, 3, 7, 40),
                                         (torch.float32, 256, 40, 512)])
def test_k10_scratch_is_what_the_launch_uses(monkeypatch, dtype, B, T, H):
    """The wrapper allocates bwd_scratch's entries and passes them with the
    plan in the entry point's order: bf16, the shifted operand (B T H
    bf16, one row for each row of hs); f32, dW's split partial products."""
    fake, made = _FakeLib(), []
    real = FR.bwd_scratch

    def recording(*a):
        made.append(real(*a))
        return made[-1]
    monkeypatch.setattr(K, "lib", lambda name, sig: fake)
    monkeypatch.setattr(K, "stream_of", lambda dev: 0)
    monkeypatch.setattr(FR, "bwd_scratch", recording)
    z = torch.zeros(B, T, H, dtype=dtype)
    FR._launch_bwd(z, torch.zeros(H, H, dtype=dtype), z)
    plan = FR.fused_rnn_bwd_plan(B, T, H, z.element_size())
    (name, args), = fake.calls
    assert len(args) == len(FR._SIG_BWD[name])
    n, part_dtype = made[0]
    if dtype == BF:
        assert name == "fused_rnn_bwd_bf16_launch"
        assert (n, part_dtype) == (B * T * H, BF)
        assert args[5] is not None
        assert list(args[14:18]) == [*plan.dw_tile, plan.dw_rows,
                                     plan.dw_splits]
    else:
        assert name == "fused_rnn_bwd_launch"
        assert plan.dw_splits > 1
        assert (n, part_dtype) == (plan.dw_splits * H * H, torch.float32)
        assert list(args[14:16]) == [plan.dw_rows, plan.dw_splits]
    walk = plan.walk
    assert list(args[6:14]) == [B, T, H, walk.cluster, walk.cols,
                                walk.batch_tile, walk.clusters,
                                walk.smem_bytes]


def test_shifted_operand_gives_the_plain_dw():
    """dW = hs^T shifted_rows(dx) over all B T rows is the plain version's
    sum over t of h_{t-1}^T da_t (h_{-1} = 0): equal in float64; in bf16
    the plain version's dW from its own dx, summed in another order,
    within one bf16 step of each entry."""
    rng = np.random.default_rng(15)
    B, T, H = 5, 9, 24
    hs = torch.tanh(torch.as_tensor(rng.normal(size=(B, T, H))))
    w = torch.as_tensor(rng.uniform(-1, 1, size=(H, H)) / 4)
    g = torch.as_tensor(rng.normal(size=(B, T, H)))
    dx, dw = FR.fused_rnn_bwd_plain(hs, w, g)
    sh = FR.shifted_rows(dx)
    assert torch.equal(sh[:, :-1], dx[:, 1:])
    assert not sh[:, -1].any()
    got = hs.reshape(-1, H).T @ sh.reshape(-1, H)
    np.testing.assert_allclose(got.numpy(), dw.numpy(), rtol=0, atol=1e-12)
    hb, wb, gb = hs.to(BF), w.to(BF), g.to(BF)
    dxb, dwb = FR.fused_rnn_bwd_plain(hb, wb, gb)
    shb = FR.shifted_rows(dxb)
    model = (hb.float().reshape(-1, H).T @ shb.float().reshape(-1, H))
    step = 2.0 ** -8 * dwb.float().abs().clamp_min(2.0 ** -100)
    assert ((model.to(BF).float() - dwb.float()).abs() <= step).all()


def test_step_clock_reads_ns_a_step_by_phase():
    """step_ns: the prologue's ns, each phase's summed cycles over T steps
    as ns a step, and their sum as the step."""
    T, cpn = 4, 2.0
    per_phase = [40, 8, 16, 24, 80]             # cycles over the T steps
    stamps = [100, 300]
    for c in per_phase:
        stamps.append(stamps[-1] + c)
    out = FR.step_ns(stamps, T, cpn)
    assert out["prologue"] == 100.0
    for name, c in zip(FR.K1_PHASES, per_phase):
        assert out[name] == c / cpn / T
    assert out["step"] == sum(per_phase) / cpn / T
    assert len(stamps) == FR.CLOCK_ROWS


def test_clock_is_the_bf16_walks_and_bf16_needs_rows_of_16_bytes():
    """The clock belongs to the bf16 walk: the f32 wrappers refuse it
    before they launch. dW's product reads 16-byte rows, so at an H that is
    not a multiple of 8 the bf16 K10 plans dW over H rounded up to 8 (the
    walk writes its operands padded) and asks for the padded scratch."""
    x = torch.zeros(2, 3, 256)
    clock = torch.zeros(FR.CLOCK_ROWS, dtype=torch.int64)
    with pytest.raises(ValueError, match="bf16 walk"):
        FR._launch(x, torch.zeros(256, 256), clock)
    with pytest.raises(ValueError, match="bf16 walk"):
        FR._launch_bwd(x, torch.zeros(256, 256), x, clock)
    FR.fused_rnn_bwd_plan(4, 40, 44)
    plan = FR.fused_rnn_bwd_plan(4, 40, 44, 2)
    assert FR.pad_width(44, 2) == 48 and plan.walk.cols == 32
    assert plan == FR.fused_rnn_bwd_plan(4, 40, 48, 2)
    assert FR.bwd_scratch(plan, 4, 40, 44, BF) == (4 * 40 * 48, BF)
    assert FR.pad_scratch(4, 40, 44, BF) == 4 * 40 * 48 + 48 * 48
    assert FR.pad_scratch(4, 40, 48, BF) == 0
