"""The operand planning of the Hopper loop (``csrc/gemm_sm90.cuh``) that the
Cannon step and the ring's bf16 backward run on, on the CPU.

TMA takes a tensor map's base address and row strides only in multiples of
16 bytes, so each bf16 operand carries its own row stride ``ld``: the
plans (``ring.tma_operands_*``) at every Cannon and ring shape of
``chip_smoke.py`` (weathermixer-1b at full width: p = 2 and 4, q = 2 and
3), the checks the wrappers make on the card (``ring.check_tma``), the
padding the callers apply once per call (``ring.pad_rows``), and the
wrappers' CPU paths on padded operands and slots against the plain
versions.  The card half is ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cannon as CANNON
from repro_torch.kernels import fused_ring, ref
from repro_torch.kernels import ring as RING

BF = torch.bfloat16
# weathermixer-1b: tokens, d_model, patch dim, d_tok, d_ch
T, D, PD, D_TOK, D_CH = 16380, 4320, 4416, 8640, 4320
# chip_smoke.py's RING_SHAPES: (label, rows, d, m) of x [rows, d] @ w.T
RING_SHAPES = [("encoder", T, PD, D), ("tok_fc1", D, T, D_TOK),
               ("tok_fc2", D, D_TOK, T), ("ch_fc1", T, D, D_CH),
               ("ch_fc2", T, D_CH, D), ("decoder", T, D, PD)]


def _ld(cols):
    """The padded row stride, computed apart from the code: the least
    multiple of 8 bf16 (16 bytes) at or above cols."""
    return cols + (-cols) % 8


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("label,rows,d,m", RING_SHAPES)
def test_ring_bwd_plan_at_the_smoke_shapes(p, label, rows, d, m):
    """x [R, D/p] and w_j [M/p, D/p] are read N-major in [64][64] boxes,
    cur [R, M/p] M-major (dw) and K-major in [128][64] boxes (dx); each
    operand's ld is its width rounded up to 16 bytes, padded exactly where
    the width is not a multiple of 8 (tok_fc1's x and w_j, tok_fc2's cur:
    rows of 8,190 at p = 2 and 4,095 at p = 4)."""
    dl, mc = d // p, m // p
    ops = RING.tma_operands_ring_bwd(rows, dl, mc)
    assert set(ops) == {"x", "cur", "w_j"}
    want = {"x": (rows, dl), "cur": (rows, mc), "w_j": (mc, dl)}
    for name, op in ops.items():
        assert op.shape == want[name]
        assert op.ld == _ld(op.shape[-1]) and op.ld * 2 % 16 == 0
        assert op.padded == (op.shape[-1] % 8 != 0)
        assert "TMA" in op.describe()
    assert ops["x"].boxes == ops["w_j"].boxes == ((64, 64),)
    assert ops["cur"].boxes == ((64, 64), (64, 128))
    padded = {k for k, op in ops.items() if op.padded}
    assert padded == {"tok_fc1": {"x", "w_j"}, "tok_fc2": {"cur"}}.get(
        label, set())
    # the encoder's input is data: no dx, so no w_j and no K-major cur
    no_dx = RING.tma_operands_ring_bwd(rows, dl, mc, need_dx=False)
    assert set(no_dx) == {"x", "cur"} and no_dx["cur"].boxes == ((64, 64),)


@pytest.mark.parametrize("p,label,n_dw,n_dx", [
    (2, "encoder", 17 * 9, 128 * 9), (2, "tok_fc1", 34 * 32, 34 * 32),
    (2, "ch_fc1", 17 * 9, 128 * 9), (4, "tok_fc1", 17 * 16, 34 * 16)])
def test_ring_bwd_tiles_and_grid(p, label, n_dw, n_dx):
    """The persistent grid's [128 x 256] tiles: the dw tiles of dw_j
    [M/p, D/p] first, then the dx tiles of dx [R, D/p]; one block per SM
    (132) with a hop, fewer only without a hop and with fewer tiles."""
    _, rows, d, m = next(s for s in RING_SHAPES if s[0] == label)
    assert RING.ring_bwd_tiles(rows, d // p, m // p) == (n_dw, n_dx)
    assert RING.ring_bwd_tiles(rows, d // p, m // p, need_dx=False) == (
        n_dw, 0)
    assert RING.persistent_grid(n_dw + n_dx, hop=True) == 132
    assert RING.persistent_grid(5, hop=True) == 132
    assert RING.persistent_grid(5, hop=False) == 5
    assert RING.persistent_grid(0, hop=False) == 1


def test_python_tiles_follow_the_header():
    """The row reports' tiles and waves (ring.sm90_tiles) use the tile the
    kernels are compiled with: csrc/gemm_sm90.cuh's BM and BN."""
    import re
    text = (RING.LIBRARY.source.parent / "gemm_sm90.cuh").read_text()
    bm, bn = re.search(r"constexpr int BM = (\d+), BN = (\d+)",
                       text).groups()
    assert RING.SM90_TILE == (int(bm), int(bn))
    assert RING.sm90_tiles(int(bm) + 1, 1) == 2
    assert RING.sm90_tiles(1, int(bn) * 3) == 3


@pytest.mark.parametrize("q,ll", [(2, 1), (2, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("layer", ["tok_fc1", "tok_fc2"])
def test_cannon_plan_at_the_smoke_shapes(q, ll, layer):
    """A q x q rank's token-mix blocks: w [m, t] read K-major in [128][64]
    boxes, x [L, t, c] N-major in [64][64] boxes; tok_fc1's w is the one
    operand padded (rows of 8,190 at q = 2, 5,460 at q = 3); tok_fc2's w
    rows (4,320 or 2,880) and x's (2,160 or 1,440) are whole 16 bytes."""
    t, c = T // q, D // q
    m = D_TOK // q
    if layer == "tok_fc2":
        m, t = t, m
    ops = RING.tma_operands_cannon(ll, m, c, t)
    assert ops["w"].shape == (m, t) and ops["x"].shape == (ll, t, c)
    assert ops["w"].boxes == ((64, 128),) and ops["x"].boxes == ((64, 64),)
    for op in ops.values():
        assert op.ld == _ld(op.shape[-1])
    padded = {k for k, op in ops.items() if op.padded}
    assert padded == ({"w"} if layer == "tok_fc1" else set())


def test_cannon_plan_at_the_q3_smoke_case():
    """chip_smoke.py's q = 3 case [2, 300, 129, 70]: w's rows of 129 and
    x's of 70 both padded (to 136 and 72)."""
    ops = RING.tma_operands_cannon(2, 300, 70, 129)
    assert (ops["w"].ld, ops["x"].ld) == (136, 72)
    assert ops["w"].padded and ops["x"].padded


@pytest.mark.parametrize("shape,boxes", [((0, 8), ((64, 64),)),
                                         ((8,), ((64, 64),)),
                                         ((8, 8), ((128, 64),)),
                                         ((8, 8), ((64, 512),)),
                                         ((1 << 32, 8), ((64, 64),))])
def test_plan_raises_on_what_a_tensor_map_cannot_describe(shape, boxes):
    """An empty or 1-D operand, a box row over the 128-byte swizzle, a box
    side over 256, a dimension of 2^32: ValueError."""
    with pytest.raises(ValueError):
        RING.plan_operand("a", shape, boxes)


def _bf(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(BF)


@pytest.mark.parametrize("shape", [(5, 7), (5, 8), (3, 4, 9), (1, 97),
                                   (2, 1, 13)])
def test_pad_rows_gives_the_planned_stride_and_the_same_values(shape):
    """pad_rows keeps a tensor whose rows suit TMA and copies any other
    into rows of tma_ld; the values are the same, the rows dense."""
    t = _bf(*shape)
    p = RING.pad_rows(t)
    assert torch.equal(p, t) and p.dtype == BF
    assert RING.row_stride(p) == _ld(shape[-1])
    assert (p is t) == (shape[-1] % 8 == 0)
    op = RING.plan_operand("t", shape, ((64, 64),))
    assert RING.check_tma(p, op, "test") == op.ld
    assert RING.span_bytes(p) == int(np.prod(shape[:-1])) * op.ld * 2
    f = torch.randn(*shape)
    assert RING.pad_rows(f) is f          # only bf16 goes through TMA


def test_row_stride_of_dense_padded_and_other_layouts():
    buf = torch.empty(3, 5, 16, dtype=BF)
    assert RING.row_stride(buf[..., :9]) == 16
    assert RING.row_stride(torch.empty(4, 6)) == 6
    assert RING.row_stride(torch.empty(4, 6).t()) is None
    assert RING.row_stride(torch.empty(2, 3, 4).transpose(1, 2)) is None
    assert RING.row_stride(torch.empty(4, 16)[:, 1:9]) == 16
    # a batch not packed around its rows
    assert RING.row_stride(torch.empty(3, 6, 16)[:, :5, :9]) is None
    slot = RING.DeviceBuffer(0, (4, 9), BF, torch.device("cpu"), ld=16)
    assert RING.row_stride(slot) == 16 and not slot.is_contiguous()
    assert RING.span_bytes(slot) == 4 * 16 * 2
    assert RING.DeviceBuffer(0, (4, 9), BF, torch.device("cpu")
                             ).is_contiguous()


@pytest.mark.parametrize("case", ["dtype", "stride", "base", "layout",
                                  "shape"])
def test_check_tma_raises_on_what_the_kernel_does_not_take(case):
    """What a tensor map cannot read raises ValueError, naming the cure
    for an odd row stride (ring.pad_rows)."""
    op = RING.plan_operand("x", (6, 9), ((64, 64),))
    good = RING.pad_rows(_bf(6, 9))
    bad = {"dtype": good.float(), "stride": _bf(6, 9),
           "base": torch.empty(6 * 16 + 1, dtype=BF)[1:].view(6, 16)[:, :9],
           "layout": _bf(9, 6).t(), "shape": _bf(6, 10)}[case]
    with pytest.raises(ValueError, match="cannot be read through TMA") as e:
        RING.check_tma(bad, op, "test")
    if case == "stride":
        assert "pad_rows" in str(e.value)
    assert RING.check_tma(good, op, "test") == 16


def test_ring_bwd_cpu_path_on_padded_operands_and_slots():
    """The wrapper's plain version on padded x, w, cur and a padded
    successor slot equals ring_bwd_step_ref on the dense operands, and the
    hop copies cur's values into the slot's rows."""
    rows, dl, mc, p = 11, 9, 5, 3
    x, w, cur = _bf(rows, dl, seed=1), _bf(mc * p, dl, seed=2), \
        _bf(rows, mc, seed=3)
    xp, wp, cp = (RING.pad_rows(t) for t in (x, w, cur))
    assert all(RING.row_stride(t) == _ld(t.shape[-1])
               for t in (xp, wp, cp))
    fwd = RING.empty_rows_like(cp)
    dw = torch.empty(mc * p, dl, dtype=BF)
    acc = torch.full((rows, dl), 0.5)
    dx = torch.empty(rows, dl, dtype=BF)
    RING.ring_bwd(xp, wp, 1, cp, fwd, dw, acc, dx, first=False, last=True)
    w_j = w[mc:2 * mc]
    want_dw, want_acc = ref.ring_bwd_step_ref(x, w_j, cur,
                                              torch.full((rows, dl), 0.5))
    assert torch.equal(dw[mc:2 * mc], want_dw)
    assert torch.equal(acc, want_acc) and torch.equal(dx, want_acc.to(BF))
    assert torch.equal(fwd, cur) and RING.row_stride(fwd) == 8


def test_one_process_ring_bwd_with_odd_rows_is_the_plain_backward():
    """ring_bwd_all pads x, w and dy where their rows need it and keeps the
    slots in dy's padded layout: the result equals the plain backward's
    (ring_bwd_all_ref) bit for bit."""
    p, rows, dl, m = 3, 13, 9, 15
    xs = [_bf(rows, dl, seed=10 + r) for r in range(p)]
    ws = [_bf(m, dl, seed=20 + r) for r in range(p)]
    dys = [_bf(rows, m // p, seed=30 + r) for r in range(p)]
    got = RING.ring_bwd_all(xs, ws, dys)
    want = ref.ring_bwd_all_ref(xs, ws, dys)
    for a, b in zip(got, want):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_cannon_step_cpu_path_on_padded_operands_and_slots():
    """The Cannon wrapper's plain version on padded w and x with padded
    destination slots: out = out + w @ x (wx_ref), and the hops land in the
    slots with the sources' row strides."""
    w, x = _bf(6, 9, seed=4), _bf(2, 9, 5, seed=5)
    wp, xp = RING.pad_rows(w), RING.pad_rows(x)
    wd, xd = RING.empty_rows_like(wp), RING.empty_rows_like(xp)
    out = torch.full((2, 6, 5), 2.0)
    CANNON.cannon_step(wp, xp, out, first=False, w_dest=wd, x_dest=xd)
    assert torch.equal(out, ref.wx_ref(w, x, torch.full((2, 6, 5), 2.0)))
    assert torch.equal(wd, w) and torch.equal(xd, x)
    assert (RING.row_stride(wd), RING.row_stride(xd)) == (16, 8)


@pytest.mark.parametrize("q", [2, 3])
def test_one_process_cannon_with_odd_rows_is_the_plain_loop(q):
    """cannon_fwd_all pads every rank's blocks once and keeps its slots in
    the padded layout: bit for bit the plain step loop (wx_ref per step,
    the blocks rotated the same way)."""
    ws = [_bf(7, 9, seed=40 + r) for r in range(q * q)]
    xs = [_bf(2, 9, 5, seed=50 + r) for r in range(q * q)]
    got = CANNON.cannon_fwd_all(ws, xs, q)
    want = ref.cannon_walk_all(lambda w, x, a: ref.wx_ref(w, x, a), ws, xs,
                               q)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("who", ["ring", "cannon"])
def test_hop_into_a_slot_of_another_row_stride_raises(who):
    """A hop copies its source's span as it lies, so a destination with
    another row stride raises instead of scrambling rows."""
    if who == "ring":
        x, w, cur = _bf(4, 9), _bf(6, 9), RING.pad_rows(_bf(4, 3))
        with pytest.raises(ValueError, match="row stride"):
            RING.ring_bwd(x, w, 0, cur, _bf(4, 3), torch.empty(6, 9,
                                                               dtype=BF),
                          None, None, first=True, last=False)
    else:
        w, x = RING.pad_rows(_bf(6, 9)), _bf(2, 9, 8)
        with pytest.raises(ValueError, match="row stride"):
            CANNON.cannon_step(w, x, torch.empty(2, 6, 8), first=True,
                               w_dest=_bf(6, 9))


def test_cannon_footprint_counts_the_padded_hops():
    """The fused Cannon's slots hold the padded layout: at a 2x2 rank's
    tok_fc1 (batch 2, w rows of 8,190 padded to 8,192) the hops are
    70,778,880 and 70,761,600 bytes, each slot rounded up to 128 MiB."""
    assert fused_ring._hop_bytes(2, 4320, 8190, 2160, BF) == (
        4320 * 8192 * 2, 2 * 8190 * 2160 * 2)
    assert fused_ring._hop_bytes(2, 4320, 8190, 2160, torch.float32) == (
        4320 * 8190 * 4, 2 * 8190 * 2160 * 4)
    assert fused_ring.cannon_footprint_bytes(
        2, 4320, 8190, 2160, BF) == 4 * (128 << 20)
