"""The port's 1-D Jigsaw products against the dense product, against each
other, and against the JAX package's ``jigsaw_matmul_1d``; the ring
kernels' plain versions; the 1-D parameter shards.

The port's ranks are gloo processes (this file run as a script with
``--rank``), p = 2 and p = 4, joined through a ``file://`` store in the
test's temporary directory.  The reference runs its 1-D mesh on four
host-emulated devices in a subprocess (``--reference``).  On the CPU the
``ring_fused`` impl runs its kernels' plain versions (the chunk walk, and
the gather plus local backward), never loading the kernel library.

Tolerances: the three rings are held to each other bit for bit on
integer-valued operands (every f32 and bf16 sum of them is exact, so the
check is of the walk and the cast points, not of the CPU GEMM's blocking:
a column chunk of a CPU product need not equal the chunk's own product bit
for bit); every impl against the dense ``X @ W.T`` on random operands
within f32 1e-5 / bf16 3e-2 (one bf16 rounding per hop); against the
reference's f32 impls within 1e-5 (sums in another order).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import weathermixer as RW
from repro_torch.configs.registry import get_config
from repro_torch.convert import (gather_params_1d, params_from_numpy,
                                 params_to_numpy, shard_params_1d)
from repro_torch.core import tree as ptree
from repro_torch.core.api import JigsawConfig
from repro_torch.core.jigsaw import jigsaw_linear, jigsaw_matmul_1d
from repro_torch.core.sharding import Mesh1D
from repro_torch.kernels import ref, ring
from repro_torch.launch.specs import check_lm_mesh

ROOT = Path(__file__).resolve().parents[1]
PS = (2, 4)
# x [B, N, D] @ w [M, D].T: D and M divide 2 and 4
B, N, D, M = 2, 6, 16, 8
IMPLS = ("ring", "ring_chunked", "ring_fused", "rs", "allreduce")
RINGS = ("ring", "ring_chunked", "ring_fused")
DTYPES = ("float32", "bfloat16")
KERNELS = ("xla", "pallas")
DENSE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(integer: bool):
    rng = np.random.default_rng(11 if integer else 12)

    def f(*shape, scale=1.0):
        if integer:
            return rng.integers(-3, 4, size=shape).astype(np.float32)
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return dict(x=f(B, N, D), w=f(M, D, scale=D ** -0.5), dy=f(B, N, M))


def _blocks(a, p, r):
    """Rank r's blocks: x and w cut along D, dy along M."""
    dl, mc = D // p, M // p
    return {"x": a["x"][..., r * dl:(r + 1) * dl],
            "w": a["w"][:, r * dl:(r + 1) * dl],
            "dy": a["dy"][..., r * mc:(r + 1) * mc]}


# ---------------------------------------------------------------------------
# the reference (subprocess) and the port's ranks (gloo processes)
# ---------------------------------------------------------------------------

def _reference_main(path):
    """The reference's 1-D linears (ring, ring_chunked, rs) on its
    (data=1, model=4) mesh, forward and grads, on the random operands."""
    from repro.core import jigsaw as RJ
    from repro.core.sharding import RULES_1D
    from repro.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=4, data=1)
    a = {k: jnp.asarray(v) for k, v in _inputs(False).items()}
    out = {}
    with jax.set_mesh(mesh):
        for impl in ("ring", "ring_chunked", "rs"):
            def apply(x, w, impl=impl):
                return RJ.jigsaw_linear(x, w, None, rules=RULES_1D,
                                        mesh=mesh, impl=impl)

            def loss(x, w, apply=apply):
                return jnp.sum(apply(x, w) * a["dy"])
            out[f"{impl}/y"] = jax.jit(apply)(a["x"], a["w"])
            out[f"{impl}/dx"], out[f"{impl}/dw"] = jax.jit(
                jax.grad(loss, argnums=(0, 1)))(a["x"], a["w"])
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _rank_main(rank, p, init, out_dir):
    """One rank of the port's p-rank mesh: every impl and kernel on
    integer and random operands in both wire dtypes, forward and grads;
    the ring collectives; saved to p<p>_rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.kernels.fused_ring import ring_all_gather
    from repro_torch.launch.mesh import make_ring_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    mesh = make_ring_mesh(p, device="cpu")
    res = {}
    for integer in (True, False):
        blocks = _blocks(_inputs(integer), p, rank)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            for impl in IMPLS:
                for kernel in KERNELS:
                    x, w = (torch.from_numpy(blocks[k].copy()).to(dt)
                            .requires_grad_() for k in "xw")
                    y = jigsaw_matmul_1d(x, w, mesh=mesh, impl=impl,
                                         kernel=kernel)
                    dx, dw = torch.autograd.grad(
                        y, (x, w), torch.from_numpy(blocks["dy"].copy())
                        .to(dt))
                    key = f"{int(integer)}/{dtype}/{impl}/{kernel}"
                    for k, v in (("y", y), ("dx", dx), ("dw", dw)):
                        res[f"{key}/{k}"] = v.detach().float().numpy()
    # the rank-ordered gathers and the reshard, with their backward
    x = (100.0 * rank + torch.arange(6.0)).reshape(2, 3).requires_grad_()
    g = comm.all_gather(x, mesh.tp_group, -1)
    res["gather/y"] = g.detach().numpy()
    res["gather/ring"] = ring_all_gather(x.detach(), mesh.tp_group, p, rank,
                                         -1).numpy()
    (res["gather/dx"],) = torch.autograd.grad(g, x, torch.ones_like(g))
    t = (10.0 * rank + torch.arange(2.0 * p * 3)).reshape(2 * p, 3)
    t.requires_grad_()
    s = comm.all_to_all(t, mesh.tp_group, split_dim=0, cat_dim=1)
    res["swap/y"] = s.detach().numpy()
    (res["swap/dx"],) = torch.autograd.grad(s, t, s.detach())
    # the fused ring's plain path never loads the kernel library
    res["library_loaded"] = np.array(ring.LIBRARY.lib is not None)
    res["launches"] = np.array(ring.ring_fwd.launches
                               + ring.ring_bwd.launches)
    np.savez(Path(out_dir) / f"p{p}_rank{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


class Launched:
    """The reference's subprocess (four emulated devices) and the port's
    ranks (p = 2 and 4) of one test module, started together: each runs
    the module file as a script, and their results are read when a test
    first needs them."""

    def __init__(self, tmp, script, ps=PS):
        self.tmp = tmp
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        self.ranks = {p: [subprocess.Popen(
            [sys.executable, script, "--rank", str(r), str(p),
             f"file://{tmp / f'store{p}'}", str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(p)] for p in ps}
        self.ref_path = tmp / "reference.npz"
        self.ref = subprocess.Popen(
            [sys.executable, script, "--reference", str(self.ref_path)],
            env=dict(env, JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=4"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    @staticmethod
    def _wait(procs, what, timeout=600):
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, f"{what} failed:\n{err[-3000:]}"

    def rank_results(self, p):
        """[results of rank r] of the p-rank mesh."""
        self._wait(self.ranks[p], f"a rank of {p}")
        return [dict(np.load(self.tmp / f"p{p}_rank{r}.npz"))
                for r in range(p)]

    def reference(self):
        self._wait([self.ref], "the reference")
        return dict(np.load(self.ref_path))

    def close(self):
        for p in [q for qs in self.ranks.values() for q in qs] + [self.ref]:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    runs = Launched(tmp_path_factory.mktemp("ring"), __file__)
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def ranks(launched):
    return {p: launched.rank_results(p) for p in PS}


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference()


def _gathered(res, key):
    """The whole y, dx, dw from the ranks' blocks."""
    return {"y": np.concatenate([r[f"{key}/y"] for r in res], -1),
            "dx": np.concatenate([r[f"{key}/dx"] for r in res], -1),
            "dw": np.concatenate([r[f"{key}/dw"] for r in res], -1)}


def _dense(integer, dtype):
    a = _inputs(integer)
    rnd = (lambda v: torch.from_numpy(v).to(getattr(torch, dtype))
           .double().numpy())
    x, w, dy = rnd(a["x"]), rnd(a["w"]), rnd(a["dy"])
    return {"y": x @ w.T, "dx": dy @ w,
            "dw": np.einsum("bnm,bnd->md", dy, x)}


# ---------------------------------------------------------------------------
# the schedule, the dense product and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", PS)
def test_rings_bitwise_equal_on_integer_operands(ranks, p, dtype, kernel):
    """ring == ring_chunked == ring_fused bit for bit, forward and grads,
    with the f32 and the bf16 wire; on integer operands every sum is exact,
    so each also equals the dense product exactly."""
    res = ranks[p]
    want = _dense(True, dtype)
    for impl in RINGS:
        got = _gathered(res, f"1/{dtype}/{impl}/{kernel}")
        for k in ("y", "dx", "dw"):
            base = _gathered(res, f"1/{dtype}/ring/{kernel}")[k]
            assert np.array_equal(got[k], base), (impl, k)
            assert np.array_equal(got[k], want[k]), (impl, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", PS)
def test_impls_match_dense_product(ranks, p, dtype):
    """Every impl and kernel on random operands within DENSE_TOL of the
    dense X @ W.T (and its grads) of the same rounded operands."""
    want = _dense(False, dtype)
    tol = DENSE_TOL[dtype]
    for impl in IMPLS:
        for kernel in KERNELS:
            got = _gathered(ranks[p], f"0/{dtype}/{impl}/{kernel}")
            for k in ("y", "dx", "dw"):
                np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                           atol=tol,
                                           err_msg=f"{impl} {kernel} {k}")


@pytest.mark.parametrize("impl", ["ring", "ring_chunked", "rs"])
def test_impls_match_reference_1d_mesh(ranks, reference, impl):
    """The port's impls (kernel="xla") at p = 4 against the reference's
    ``jigsaw_matmul_1d`` on its four-device mesh, f32: forward and grads
    within 1e-5."""
    got = _gathered(ranks[4], f"0/float32/{impl}/xla")
    for k in ("y", "dx", "dw"):
        np.testing.assert_allclose(got[k], reference[f"{impl}/{k}"],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("p", PS)
def test_gathers_and_reshard(ranks, p):
    """all_gather and ring_all_gather give every rank's x in rank order;
    the all_gather's backward is the reduce-scatter (p ones per element);
    all_to_all hands rank r every rank's chunk r, and its backward sends
    each back to its owner."""
    x = [(100.0 * r + np.arange(6.0)).reshape(2, 3) for r in range(p)]
    t = [(10.0 * r + np.arange(2.0 * p * 3)).reshape(2 * p, 3)
         for r in range(p)]
    for r, res in enumerate(ranks[p]):
        assert np.array_equal(res["gather/y"], np.concatenate(x, -1))
        assert np.array_equal(res["gather/ring"], np.concatenate(x, -1))
        assert np.array_equal(res["gather/dx"], np.full((2, 3), float(p)))
        want = np.concatenate([t[s][2 * r:2 * r + 2] for s in range(p)], 1)
        assert np.array_equal(res["swap/y"], want)
        assert np.array_equal(res["swap/dx"], t[r])


def test_fused_ring_on_cpu_takes_plain_version(ranks):
    """Every rank ran ring_fused (both kernels, both dtypes) on CPU tensors
    without loading the ring kernels' library or counting a launch."""
    for p in PS:
        for res in ranks[p]:
            assert not res["library_loaded"] and res["launches"] == 0


# ---------------------------------------------------------------------------
# the kernels' plain versions, p ranks in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [2, 3, 4])
def test_one_process_ring_is_the_ring(p, dtype):
    """The p-rank one-process form of the step kernels (their plain
    versions here): the forward equals the ring walk of the local products
    bit for bit, the backward the gathered cotangent's dw and dx, on
    integer operands (exact sums)."""
    rng = np.random.default_rng(p)
    rows, dl, mc = 5, 3, 2
    dt = getattr(torch, dtype)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-3, 4, size=shape)
                                .astype(np.float32)).to(dt)
    xs = [ints(rows, dl) for _ in range(p)]
    ws = [ints(mc * p, dl) for _ in range(p)]
    dys = [ints(rows, mc) for _ in range(p)]
    before = (ring.ring_fwd.launches, ring.ring_bwd.launches)
    outs = ring.ring_fwd_all(xs, ws)
    dxs, dws, accs = ring.ring_bwd_all(xs, ws, dys)
    assert (ring.ring_fwd.launches, ring.ring_bwd.launches) == before
    x = torch.cat(xs, 1).double()
    w = torch.cat(ws, 1).double()
    dy = torch.cat(dys, 1).double()
    y = x @ w.t()
    for r in range(p):
        cut = slice(r * dl, (r + 1) * dl)
        assert torch.equal(outs[r].double(), y[:, r * mc:(r + 1) * mc])
        assert torch.equal(dxs[r].double(), (dy @ w)[:, cut])
        assert torch.equal(dws[r].double(), (dy.t() @ x)[:, cut])
        assert accs[r].dtype == torch.float32
    # the plain references agree with the one-process steps bit for bit
    assert all(torch.equal(a, b) for a, b in
               zip(outs, ref.ring_fwd_all_ref(xs, ws, torch.float32)))
    pdx, pdw, _ = ref.ring_bwd_all_ref(xs, ws, dys)
    assert all(torch.equal(a, b) for a, b in zip(dxs + dws, pdx + pdw))


def test_ring_step_rounds_in_the_accumulator_dtype():
    """With an f32 wire, accum_dtype=bf16 rounds the chunk product, the
    arrived partial and their sum to bf16 (the chunk walk's ``.to(acc)``
    points); an f32 accumulator keeps them.  (With a bf16 wire the two
    agree: every hop rounds to bf16 anyway.)"""
    x = torch.tensor([[1.0]])
    w = torch.tensor([[1.0 + 2 ** -10], [3.0]])
    prev = torch.tensor([[2.0 ** -9]])
    for acc, want in ((torch.bfloat16, 1.0),
                      (torch.float32, 1.0 + 2 ** -10 + 2 ** -9)):
        dest = torch.empty(1, 1)
        ring.ring_fwd(x, w, 0, prev, dest, accum_dtype=acc)
        assert float(dest) == want, acc


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_prev", [False, True])
def test_ring_fwd_on_padded_operands_equals_the_contiguous_call(with_prev,
                                                                acc):
    """x and w with rows of 9 bf16 padded to 16 (``pad_rows``, as the
    callers hand them to the Hopper forward) give the step the contiguous
    operands give, bit for bit, with or without an arrived partial."""
    rng = np.random.default_rng(11)
    rows, k, mc, p = 7, 9, 5, 3
    x, w = _bf16(rng, rows, k), _bf16(rng, mc * p, k)
    prev = _bf16(rng, rows, mc) if with_prev else None
    xp, wp = ring.pad_rows(x), ring.pad_rows(w)
    assert ring.row_stride(xp) == ring.row_stride(wp) == 16
    for j in range(p):
        want = torch.empty(rows, mc, dtype=torch.bfloat16)
        got = torch.empty(rows, mc, dtype=torch.bfloat16)
        ring.ring_fwd(x, w, j, prev, want, accum_dtype=acc)
        ring.ring_fwd(xp, wp, j, prev, got, accum_dtype=acc)
        assert torch.equal(got, want), j


@pytest.mark.parametrize("p", [2, 3])
def test_one_process_ring_fwd_with_odd_rows_is_the_plain_forward(p):
    """ring_fwd_all pads each rank's x and w where their rows need it (rows
    of 13 bf16) and keeps the partials contiguous: bit for bit the plain
    forward ring (ring_fwd_all_ref)."""
    rng = np.random.default_rng(p)
    xs = [_bf16(rng, 6, 13) for _ in range(p)]
    ws = [_bf16(rng, 5 * p, 13) for _ in range(p)]
    got = ring.ring_fwd_all(xs, ws)
    want = ref.ring_fwd_all_ref(xs, ws, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case,exc", [
    ("m_not_divisible", ValueError), ("gspmd", NotImplementedError),
    ("unknown_impl", ValueError), ("config_gspmd", NotImplementedError),
    ("config_fsdp", NotImplementedError), ("fsdp_no_bias", ValueError),
    ("step_chunk", ValueError), ("step_dtype", TypeError),
    ("step_dest", ValueError), ("linear_blocks", ValueError)])
def test_bad_inputs_raise(case, exc):
    """Inputs the 1-D path does not take raise before any collective: an
    out dim p does not divide, the impls that are not ported, the FSDP
    hybrid's cut of a language model over two data ranks, an FSDP
    linear with no bias to tell its whole out dim, blocks that do not
    contract, a ring step outside its chunks or with mismatched
    buffers."""
    mesh = Mesh1D(p=2, r=0)         # no group: nothing may communicate
    x, w = torch.randn(3, 4), torch.randn(6, 4)
    with pytest.raises(exc):
        if case == "m_not_divisible":
            jigsaw_matmul_1d(x, torch.randn(5, 4), mesh=mesh, impl="ring")
        elif case == "gspmd":
            jigsaw_matmul_1d(x, w, mesh=mesh, impl="gspmd")
        elif case == "unknown_impl":
            jigsaw_matmul_1d(x, w, mesh=mesh, impl="psum")
        elif case == "config_gspmd":
            JigsawConfig(scheme="1d", impl="gspmd")
        elif case == "config_fsdp":
            check_lm_mesh(get_config("mamba2-130m").replace(
                scheme="1d", shard_params_over_data=True), 2, fsdp=True)
        elif case == "fsdp_no_bias":
            jigsaw_linear(x, w, mesh=Mesh1D(p=2, r=0, data_size=2),
                          fsdp=True)
        elif case == "step_chunk":
            ring.ring_fwd(x, w, 2, None, torch.empty(3, 3))
        elif case == "step_dtype":
            ring.ring_fwd(x, w.double(), 0, None, torch.empty(3, 3))
        elif case == "linear_blocks":
            jigsaw_linear(x, torch.randn(6, 3), mesh=mesh)
        elif case == "step_dest":
            ring.ring_fwd(x, w, 0, None, torch.empty(3, 3,
                                                     dtype=torch.bfloat16))


@pytest.mark.parametrize("collective", [True, False])
def test_workspace_close(monkeypatch, collective):
    """``release_workspaces`` closes every group's slots: the collective
    close synchronises, unmaps the peer's slots, waits for the group
    and frees this rank's; the local one (after an error) only unmaps.
    ``workspace_bytes`` counts the live slots (raw cudaMallocs, outside
    torch's allocator statistics)."""
    from types import SimpleNamespace
    calls = []
    lib = SimpleNamespace(
        ring_slots_close=lambda p: calls.append(("close", p)) or 0,
        ring_slots_free=lambda p: calls.append(("free", p)) or 0)
    monkeypatch.setattr(ring, "LIBRARY", SimpleNamespace(lib=lib))
    monkeypatch.setattr(ring.dist, "barrier",
                        lambda group: calls.append(("barrier", group)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device: calls.append(("sync", device)))
    ws = object.__new__(ring.RingWorkspace)
    ws.group, ws.device, ws.slot_bytes = "g", "cuda:0", 3 << 20
    ws.own_ptr, ws.peer_ptr = 1000, 2000
    monkeypatch.setitem(ring._WORKSPACES, "g", ws)
    assert ring.workspace_bytes() == 6 << 20
    ring.release_workspaces(collective)
    want = ([("sync", "cuda:0"), ("close", 2000), ("barrier", "g"),
             ("free", 1000)] if collective else [("close", 2000)])
    assert calls == want and ring.workspace_bytes() == 0
    assert ws.peer_ptr is None and (ws.own_ptr is None) == collective


# ---------------------------------------------------------------------------
# the parameter shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_shard_then_gather_1d_round_trips_bit_for_bit(param_dtype):
    """Reference pytree (numpy, blocks stacked) and the port's tensors:
    each rank's shard has the 1-D layout of launch/specs.py (every w on its
    contracting dim, every b on its out dim, LayerNorm and blend whole), and
    the gather gives the whole tree back bit for bit."""
    p = 4
    cfg = ref_get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=96,
        wm_d_ch=80, param_dtype=param_dtype)
    tree = jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(0), cfg))
    shards = [shard_params_1d(tree, r, p) for r in range(p)]
    s1 = shards[1]
    assert np.array_equal(s1["encoder"]["w"], tree["encoder"]["w"][:, 16:32])
    assert np.array_equal(s1["encoder"]["b"], tree["encoder"]["b"][16:32])
    assert np.array_equal(s1["blocks"]["tok_fc1"]["w"],
                          tree["blocks"]["tok_fc1"]["w"][:, :, 8:16])
    assert np.array_equal(s1["blocks"]["tok_fc1"]["b"],
                          tree["blocks"]["tok_fc1"]["b"][:, 24:48])
    assert s1["blocks"]["ch_norm"]["scale"].shape == (cfg.n_layers, 64)
    assert s1["blend"].shape == (4,)
    back = gather_params_1d(shards, p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    port = params_from_numpy(tree, device="cpu")
    pshards = [shard_params_1d(port, r, p) for r in range(p)]
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(ptree.leaves(pshards[0]), ptree.leaves(port)))
    again = params_to_numpy(gather_params_1d(pshards, p),
                            bf16_dtype=tree["encoder"]["w"].dtype)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
