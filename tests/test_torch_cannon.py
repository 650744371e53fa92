"""The port's 2-D Jigsaw pieces against the JAX package's: the wx kernel's
plain version and its autograd Function, the Cannon kernel's wrapper and
plain versions, the rotations and skews, the fused Cannon
(``fused_cannon_t``) and the Cannon linears, and the parameter shards.

The reference runs as its own tests run it: Pallas in interpret mode, and
the 2x2 mesh on four host-emulated devices in a subprocess (this file run
as a script with ``--reference``).  The port's 2x2 mesh is four processes
(this file run as a script with ``--rank``) joined under gloo through a
``file://`` store in the test's temporary directory, so no two test
workers share a port.  Inputs come from numpy seeds.

Tolerances: f32 1e-5 forward and 1e-4 gradients (the reference's own
Cannon parity bounds, DESIGN.md §11; sums run in another order); bf16
3e-2 (one bf16 rounding of the operands); rotations are exact.
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
from repro.kernels import fused_ring as ref_fused_ring
from repro.models import weathermixer as RW
from repro_torch.convert import (gather_params_2d, params_from_numpy,
                                 params_to_numpy, shard_params_2d)
from repro_torch.core import tree as ptree
from repro_torch.kernels import cannon as CANNON
from repro_torch.kernels import fused_ring, ref
from repro_torch.kernels import wx as WX

ROOT = Path(__file__).resolve().parents[1]
Q = 2
# linear_2d: x [B, N, D] @ w [M, D].T; linear_2d_t: w [MT, T] @ x [B, T, C]
B, N, D, M = 2, 12, 20, 16
T, C, MT = 20, 12, 24
KERNELS = ("xla", "pallas")


def _fused_inputs():
    """Global w [MT, T] (mdom, mtp), x and dy [B, T, C] / [B, MT, C]
    (None, mdom, mtp): each rank's blocks are the fused Cannon's skewed
    operands."""
    rng = np.random.default_rng(11)
    return dict(w=(rng.normal(size=(MT, T)) / T ** 0.5).astype(np.float32),
                x=rng.normal(size=(B, T, C)).astype(np.float32),
                dy=rng.normal(size=(B, MT, C)).astype(np.float32))


_FUSED_SPECS = dict(w=((0, 0), (1, 1)), x=((1, 0), (2, 1)),
                    dy=((1, 0), (2, 1)))


def _inputs():
    rng = np.random.default_rng(7)

    def f(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return {"l2d": dict(x=f(B, N, D), w=f(M, D, scale=D ** -0.5),
                        b=f(M, scale=0.1), dy=f(B, N, M)),
            "l2dt": dict(x=f(B, T, C), w=f(MT, T, scale=T ** -0.5),
                         b=f(MT, scale=0.1), dy=f(B, MT, C))}


# block specs of each operand: (dim, axis) pairs, axis 0 = mdom (i), 1 = mtp
_SPECS = {"l2d": dict(x=((1, 0), (2, 1)), w=((0, 1), (1, 0)), b=((0, 1),),
                      dy=((1, 0), (2, 1))),
          "l2dt": dict(x=((1, 0), (2, 1)), w=((0, 0), (1, 1)), b=((0, 0),),
                       dy=((1, 0), (2, 1)))}


def _block(a, spec, i, j):
    index = [slice(None)] * a.ndim
    for dim, axis in spec:
        n = a.shape[dim] // Q
        c = (i, j)[axis]
        index[dim] = slice(c * n, (c + 1) * n)
    return a[tuple(index)]


def _assemble(blocks, spec):
    """The whole array from the blocks of ranks r = i * Q + j."""
    (d0, a0), (d1, a1) = spec
    grid = [[blocks[(i, j) if a0 == 0 else (j, i)] for j in range(Q)]
            for i in range(Q)]
    return np.concatenate([np.concatenate(row, d1) for row in grid], d0)


# ---------------------------------------------------------------------------
# the reference (subprocess) and the port's ranks (gloo processes)
# ---------------------------------------------------------------------------

def _reference_main(path):
    """The reference's 2x2 Cannon linears, forward and grads, Pallas in
    interpret mode (this file run on four emulated devices)."""
    from repro.core import jigsaw as RJ
    from repro.core.sharding import RULES_2D
    from repro.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=4, data=1, two_d=True)
    out = {}
    with jax.set_mesh(mesh):
        for name, fn in (("l2d", RJ.jigsaw_linear_2d),
                         ("l2dt", RJ.jigsaw_linear_2d_t)):
            a = {k: jnp.asarray(v) for k, v in _inputs()[name].items()}

            def apply(x, w, b, fn=fn):
                return fn(x, w, b, rules=RULES_2D, kernel="pallas")

            def loss(x, w, b, dy=a["dy"], apply=apply):
                return jnp.sum(apply(x, w, b) * dy)
            out[f"{name}/y"] = jax.jit(apply)(a["x"], a["w"], a["b"])
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
                a["x"], a["w"], a["b"])
            for k, g in zip("xwb", grads):
                out[f"{name}/d{k}"] = g
        # the fused Cannon on every rank's blocks, under jax.vjp
        from jax.sharding import PartitionSpec as P
        from repro.compat import shard_map
        fused = shard_map(
            lambda w, x: ref_fused_ring.fused_cannon_t(
                w, x, dom_axis="mdom", tp_axis="mtp", q=Q),
            mesh=mesh, in_specs=(P("mdom", "mtp"), P(None, "mdom", "mtp")),
            out_specs=P(None, "mdom", "mtp"), axis_names={"mdom", "mtp"},
            check_vma=False)
        a = {k: jnp.asarray(v) for k, v in _fused_inputs().items()}
        for dt in ("float32", "bfloat16"):
            y, vjp = jax.vjp(jax.jit(fused), a["w"].astype(dt),
                             a["x"].astype(dt))
            dw, dx = vjp(a["dy"])
            out.update({f"fused/{dt}/y": y, f"fused/{dt}/dw": dw,
                        f"fused/{dt}/dx": dx})
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in out.items()})


def _rank_main(rank, init, out_dir):
    """One rank of the port's 2x2 mesh: rotations, skews and both Cannon
    linears on its blocks, forward and grads, saved to rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.jigsaw import jigsaw_linear_2d, jigsaw_linear_2d_t
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=Q * Q)
    mesh = make_host_mesh(Q * Q, device="cpu")
    i, j = mesh.i, mesh.j
    res = {"ij": np.array([i, j])}
    # rotations: block (i, j) holds 100 * (i * Q + j) + arange
    x = (100.0 * (i * Q + j) + torch.arange(6.0)).reshape(2, 3)
    g = -x - 0.5
    for name, group, shift in (("tp1", mesh.tp_group, 1),
                               ("dom1", mesh.dom_group, 1),
                               ("tp_skew", mesh.tp_group, i),
                               ("dom_skew", mesh.dom_group, j),
                               ("tp_full", mesh.tp_group, Q)):
        xl = x.clone().requires_grad_()
        y = comm.rotate(xl, group, shift)
        (gx,) = torch.autograd.grad(y, xl, g)
        res[f"rot/{name}/y"], res[f"rot/{name}/dx"] = (y.detach().numpy(),
                                                      gx.numpy())
    for name, fn in (("l2d", jigsaw_linear_2d),
                     ("l2dt", jigsaw_linear_2d_t)):
        blocks = {k: torch.from_numpy(np.ascontiguousarray(
            _block(v, _SPECS[name][k], i, j)))
            for k, v in _inputs()[name].items()}
        for kernel in KERNELS:
            leaves = [blocks[k].clone().requires_grad_() for k in "xwb"]
            y = fn(*leaves, mesh=mesh, kernel=kernel)
            grads = torch.autograd.grad(y, leaves, blocks["dy"])
            res[f"{name}/{kernel}/y"] = y.detach().numpy()
            for k, gk in zip("xwb", grads):
                res[f"{name}/{kernel}/d{k}"] = gk.numpy()
    # the fused Cannon (its plain path on the CPU), and the step loop
    blocks = {k: torch.from_numpy(np.ascontiguousarray(
        _block(v, _FUSED_SPECS[k], i, j))) for k, v in _fused_inputs().items()}
    groups = dict(dom_group=mesh.dom_group, tp_group=mesh.tp_group, q=Q)
    for dt in ("float32", "bfloat16"):
        outs = []
        for fn in (fused_ring.fused_cannon_t, fused_ring.cannon_t_loop):
            leaves = [blocks[k].to(getattr(torch, dt)).requires_grad_()
                      for k in "wx"]
            kw = dict(groups, model_group=mesh.model_group) \
                if fn is fused_ring.fused_cannon_t else groups
            y = fn(*leaves, **kw)
            outs.append([y] + list(torch.autograd.grad(y, leaves,
                                                       blocks["dy"])))
        res[f"fused/{dt}/node"] = np.array(type(outs[0][0].grad_fn).__name__)
        for k, got, loop in zip(("y", "dw", "dx"), *outs):
            res[f"fused/{dt}/{k}"] = got.detach().float().numpy()
            res[f"fused/{dt}/{k}_equal_loop"] = np.array(
                torch.equal(got, loop) and got.dtype == loop.dtype)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


class Launched:
    """The reference's subprocess (``devices`` emulated devices) and the
    port's ``ranks`` gloo ranks of one test module, started together: each
    runs the module file as a script, and their results are read when a
    test first needs them (four of each unless the module asks for
    others)."""

    def __init__(self, tmp, script, ranks=Q * Q, devices=Q * Q):
        self.tmp, self.n = tmp, ranks
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        init = f"file://{tmp / 'store'}"
        self.ranks = [subprocess.Popen(
            [sys.executable, script, "--rank", str(r), init, str(tmp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(ranks)]
        self.ref_path = tmp / "reference.npz"
        self.ref = subprocess.Popen(
            [sys.executable, script, "--reference", str(self.ref_path)],
            env=dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
                f"--xla_force_host_platform_device_count={devices}")),
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

    def rank_results(self):
        """{coordinates: results} of the ranks (each saves its coordinates
        on its mesh as "ij": (i, j) on the 2x2 mesh)."""
        self._wait(self.ranks, "a rank")
        res = [dict(np.load(self.tmp / f"rank{r}.npz"))
               for r in range(self.n)]
        return {tuple(r["ij"]): r for r in res}

    def reference(self):
        self._wait([self.ref], "the reference")
        return dict(np.load(self.ref_path))

    def close(self):
        for p in self.ranks + [self.ref]:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    runs = Launched(tmp_path_factory.mktemp("cannon"), __file__)
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def ranks(launched):
    return launched.rank_results()


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference()


# ---------------------------------------------------------------------------
# the wx kernel's plain version and Function vs cannon_t_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,lead,with_acc", [
    ("float32", (), False), ("float32", (3,), True),
    ("float32", (3,), False), ("float32", (), True),
    ("bfloat16", (3,), True), ("bfloat16", (), False)])
def test_cannon_t_step_matches_reference(dtype, lead, with_acc):
    """acc + w @ x and its grads in w, x and acc: t = 20 (not a multiple
    of 8), L = 1 (no lead dim) and 3; the reference in interpret mode."""
    rng = np.random.default_rng(len(lead) + 2 * with_acc)
    m, t, c = 24, 20, 12
    w = (rng.normal(size=(m, t)) / t ** 0.5).astype(np.float32)
    x = rng.normal(size=lead + (t, c)).astype(np.float32)
    acc = rng.normal(size=lead + (m, c)).astype(np.float32)
    dy = rng.normal(size=lead + (m, c)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def ref_fn(w_, x_, a_):
        return ref_fused_ring.cannon_t_step(w_, x_, a_ if with_acc else None)

    rw, rx, ra = (jnp.asarray(w).astype(jdt), jnp.asarray(x).astype(jdt),
                  jnp.asarray(acc))
    want = ref_fn(rw, rx, ra)
    want_g = jax.grad(lambda *a: jnp.sum(ref_fn(*a) * dy),
                      argnums=(0, 1, 2))(rw, rx, ra)

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(w).to(tdt).requires_grad_(),
              torch.from_numpy(x).to(tdt).requires_grad_(),
              torch.from_numpy(acc).requires_grad_()]
    got = fused_ring.cannon_t_step(leaves[0], leaves[1],
                                   leaves[2] if with_acc else None)
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(dy),
                                allow_unused=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    fwd_tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (3e-2, 3e-2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=fwd_tol, atol=fwd_tol)
    for g, r, k in zip(got_g, want_g, "wxa"):
        if k == "a" and not with_acc:
            assert g is None
            continue
        assert str(g.dtype).removeprefix("torch.") == str(r.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=grad_tol, atol=grad_tol)


def test_wx_on_cpu_takes_plain_version_without_launching():
    """On CPU tensors the wrapper computes ``ref.wx_ref`` (w read along or
    across its rows, with and without a, f32 or bf16 out) and counts no
    launch."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(7, 5, generator=g)
    x = torch.randn(3, 5, 4, generator=g)
    a = torch.randn(3, 7, 4, generator=g)
    before = WX.wx.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        got = WX.wx(w, x, a.to(out_dtype), out_dtype=out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, ref.wx_ref(w, x, a.to(out_dtype),
                                           out_dtype))
    want = torch.einsum("mt,ltc->lmc", w, x)
    for got in (WX.wx(w, x), WX.wx(w.t().contiguous(), x, w_t=True)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert WX.wx.launches == before


@pytest.mark.parametrize("case,exc", [
    ("w_dim", ValueError), ("k", ValueError), ("dtype", TypeError),
    ("out_dtype", TypeError), ("a_shape", ValueError),
    ("a_dtype", ValueError)])
def test_wx_rejects_bad_inputs(case, exc):
    w, x = torch.randn(6, 4), torch.randn(2, 4, 3)
    a, kw = torch.randn(2, 6, 3), {}
    if case == "w_dim":
        w = w[None]
    elif case == "k":
        x = torch.randn(2, 5, 3)
    elif case == "dtype":
        x = x.to(torch.bfloat16)
    elif case == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif case == "a_shape":
        a = a[:, :5]
    elif case == "a_dtype":
        a = a.double()
    with pytest.raises(exc):
        WX.wx(w, x, a, **kw)


def test_cannon_step_calls_wx_and_block_matmul(monkeypatch):
    """One step: one wx launch forward; backward one wx (dx, w read across
    its rows: the bf16 w as it is, against the f32 cotangent, wx's dx
    entry) and one block_matmul (dw, L folded into the contraction)."""
    calls = []

    def count(name, real):
        def f(*a, **kw):
            calls.append((name, kw.get("w_t", False), a[0].dtype))
            return real(*a, **kw)
        return f
    monkeypatch.setattr(fused_ring, "wx", count("wx", fused_ring.wx))
    monkeypatch.setattr(fused_ring, "block_matmul",
                        count("bm", fused_ring.block_matmul))
    w = torch.randn(8, 6, dtype=torch.bfloat16, requires_grad=True)
    x = torch.randn(3, 6, 5, dtype=torch.bfloat16, requires_grad=True)
    y = fused_ring.cannon_t_step(w, x, None)
    assert calls == [("wx", False, torch.bfloat16)]
    dw, dx = torch.autograd.grad(y, (w, x), torch.randn(3, 8, 5))
    assert sorted(calls[1:], key=str) == [("bm", False, torch.bfloat16),
                                          ("wx", True, torch.bfloat16)]
    assert dw.dtype == dx.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# rotations, skews and the Cannon linears on 2x2 gloo ranks
# ---------------------------------------------------------------------------

def test_rotations_and_skews_match_np_roll(ranks):
    """rotate(x, group, s): rank r gets the block of rank r + s of its
    group (np.roll of the stacked blocks by -s); its gradient goes back to
    the owner.  Skews rotate by the rank's index on the other axis."""
    x = {ij: (100.0 * (ij[0] * Q + ij[1]) + np.arange(6.0)).reshape(2, 3)
         for ij in ranks}
    g = {ij: -v - 0.5 for ij, v in x.items()}
    for (i, j), res in ranks.items():
        cases = {"tp1": ((i, (j + 1) % Q), (i, (j - 1) % Q)),
                 "dom1": (((i + 1) % Q, j), ((i - 1) % Q, j)),
                 "tp_skew": ((i, (j + i) % Q), (i, (j - i) % Q)),
                 "dom_skew": (((i + j) % Q, j), ((i - j) % Q, j)),
                 "tp_full": ((i, j), (i, j))}
        for name, (src, dst) in cases.items():
            assert np.array_equal(res[f"rot/{name}/y"], x[src]), name
            assert np.array_equal(res[f"rot/{name}/dx"], g[dst]), name


def _gathered(ranks, name, kernel):
    """The whole y, dx, dw of a linear from the ranks' blocks, and db
    summed over the ranks that share each block."""
    specs = _SPECS[name]
    out = {}
    for k, spec_key in (("y", "dy"), ("dx", "x"), ("dw", "w")):
        out[k] = _assemble({ij: r[f"{name}/{kernel}/{k}"]
                            for ij, r in ranks.items()}, specs[spec_key])
    (_, axis), = specs["b"]
    db = [sum(r[f"{name}/{kernel}/db"] for ij, r in ranks.items()
              if ij[axis] == c) for c in range(Q)]
    out["db"] = np.concatenate(db)
    return out


def _dense(name):
    a = _inputs()[name]
    x, w, b, dy = (a[k].astype(np.float64) for k in ("x", "w", "b", "dy"))
    if name == "l2d":
        return {"y": x @ w.T + b, "dx": dy @ w,
                "dw": np.einsum("bnm,bnd->md", dy, x), "db": dy.sum((0, 1))}
    return {"y": np.einsum("mt,btc->bmc", w, x) + b[:, None],
            "dx": np.einsum("mt,bmc->btc", w, dy),
            "dw": np.einsum("bmc,btc->mt", dy, x), "db": dy.sum((0, 2))}


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", ["l2d", "l2dt"])
def test_cannon_linears_match_dense_product(ranks, name, kernel):
    got, want = _gathered(ranks, name, kernel), _dense(name)
    for k in ("y", "dx", "dw", "db"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["l2d", "l2dt"])
def test_cannon_linears_match_reference_2x2(ranks, reference, name):
    """The port's kernel="pallas" Cannon (the kernels' plain versions on
    the CPU) against the reference's on its 2x2 mesh, Pallas in interpret
    mode: forward 1e-5, grads 1e-4."""
    got = _gathered(ranks, name, "pallas")
    np.testing.assert_allclose(got["y"], reference[f"{name}/y"], rtol=1e-5,
                               atol=1e-5)
    for k in ("dx", "dw", "db"):
        np.testing.assert_allclose(got[k], reference[f"{name}/{k}"],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_cannon_matches_reference_2x2(ranks, reference, dtype):
    """The port's fused_cannon_t (an autograd Function; on the CPU its
    forward is the step loop and its backward the step loop's VJP,
    recomputed) against the reference's under jax.vjp on its 2x2 mesh,
    Pallas in interpret mode: f32 forward 1e-5 and grads 1e-4, bf16 3e-2.
    On every rank forward and grads equal the step loop's bit for bit."""
    fwd_tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (3e-2, 3e-2)
    for k, tol in (("y", fwd_tol), ("dw", grad_tol), ("dx", grad_tol)):
        spec = _FUSED_SPECS["dy" if k == "y" else k[1]]
        got = _assemble({ij: r[f"fused/{dtype}/{k}"]
                         for ij, r in ranks.items()}, spec)
        np.testing.assert_allclose(got, reference[f"fused/{dtype}/{k}"],
                                   rtol=tol, atol=tol, err_msg=k)
    for r in ranks.values():
        assert str(r[f"fused/{dtype}/node"]) == "_FusedCannonBackward"
        assert all(bool(r[f"fused/{dtype}/{k}_equal_loop"])
                   for k in ("y", "dw", "dx"))


# ---------------------------------------------------------------------------
# the Cannon kernel's wrapper and plain versions, one process
# ---------------------------------------------------------------------------

def _cannon_blocks(q, ll, m, t, c, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn(m, t, generator=g) / t ** 0.5).to(dtype)
          for _ in range(q * q)]
    xs = [torch.randn(ll, t, c, generator=g).to(dtype) for _ in range(q * q)]
    return ws, xs


@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cannon_fwd_all_on_cpu_is_the_step_loop(q, out_dtype):
    """q x q ranks in one process on CPU tensors: the wrapper's plain
    version, step by step, equals the step loop of wx steps rotated the
    same way bit for bit, and the plain Cannon (one rounding at the end)
    within the accumulator's rounding; rank (i, j) ends with
    sum_s W(i, j+s) @ X(i+s, j).  No launch is counted."""
    ws, xs = _cannon_blocks(q, 2, 7, 5, 3)
    before = CANNON.cannon_step.launches
    got = CANNON.cannon_fwd_all(ws, xs, q, accum_dtype=out_dtype)
    assert CANNON.cannon_step.launches == before
    loop = ref.cannon_walk_all(
        lambda w, x, a: WX.wx(w, x, a, out_dtype=out_dtype), ws, xs, q)
    plain = ref.cannon_ref(ws, xs, q, out_dtype)
    tol = 1e-5 if out_dtype == torch.float32 else 2e-2
    for r, (a, b, c) in enumerate(zip(got, loop, plain)):
        assert a.dtype == out_dtype and torch.equal(a, b), r
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                                   rtol=tol, atol=tol)
        i, j = divmod(r, q)
        want = sum(ws[i * q + (j + s) % q] @ xs[(i + s) % q * q + j]
                   for s in range(q))
        np.testing.assert_allclose(c.float().numpy(), want.numpy(),
                                   rtol=tol, atol=tol)


def test_cannon_step_copies_the_hops_on_cpu():
    """One step: out = (0 if first else out) + w @ x[l], and w, x copied to
    the destinations given."""
    ws, xs = _cannon_blocks(1, 3, 6, 4, 5)
    w, x = ws[0], xs[0]
    out = torch.full((3, 6, 5), 2.0)
    wd, xd = torch.zeros_like(w), torch.zeros_like(x)
    CANNON.cannon_step(w, x, out, first=False, w_dest=wd, x_dest=xd)
    assert torch.equal(out, ref.wx_ref(w, x, torch.full((3, 6, 5), 2.0)))
    assert torch.equal(wd, w) and torch.equal(xd, x)
    CANNON.cannon_step(w, x, out, first=True)
    assert torch.equal(out, ref.wx_ref(w, x))


@pytest.mark.parametrize("case,exc", [
    ("w_dim", ValueError), ("k", ValueError), ("dtype", TypeError),
    ("x_layout", ValueError), ("out_shape", ValueError),
    ("out_dtype", TypeError), ("dest_shape", ValueError),
    ("dest_dtype", ValueError)])
def test_cannon_step_rejects_bad_inputs(case, exc):
    w, x = torch.randn(6, 4), torch.randn(2, 4, 3)
    out, kw = torch.empty(2, 6, 3), {}
    if case == "w_dim":
        w = w[None]
    elif case == "k":
        x = torch.randn(2, 5, 3)
    elif case == "dtype":
        x = x.to(torch.bfloat16)
    elif case == "x_layout":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "out_shape":
        out = out[:, :5]
    elif case == "out_dtype":
        out = out.double()
    elif case == "dest_shape":
        kw["x_dest"] = torch.empty(2, 4, 2)
    elif case == "dest_dtype":
        kw["w_dest"] = torch.empty(6, 4, dtype=torch.bfloat16)
    with pytest.raises(exc):
        CANNON.cannon_step(w, x, out, first=True, **kw)


def test_cannon_path_and_footprint():
    """The CPU takes the step loop; the card's slots at a 2x2 rank of
    weathermixer-1b (batch 2, bf16: w hops of 70.8 MB and x hops of
    70.8 MB, each rounded up to 128 MiB) are 512 MiB per rank."""
    assert fused_ring.cannon_path(2, 4320, 8190, 2160, torch.bfloat16,
                                  "cpu") == "step"
    assert fused_ring.cannon_footprint_bytes(
        2, 4320, 8190, 2160, torch.bfloat16) == 4 * (128 << 20)


def test_fused_cannon_at_q1_is_the_step_loop():
    """At q = 1 fused_cannon_t is cannon_t_loop itself (one wx step, its
    own VJP: no recompute), as the reference's _fused_cannon at q = 1."""
    ws, xs = _cannon_blocks(1, 2, 5, 4, 3)
    w = ws[0].requires_grad_()
    y = fused_ring.fused_cannon_t(w, xs[0], dom_group=None, tp_group=None,
                                  model_group=None, q=1)
    assert type(y.grad_fn).__name__ != "_FusedCannonBackward"
    assert torch.equal(y, fused_ring.cannon_t_loop(
        w, xs[0], dom_group=None, tp_group=None, q=1))


# ---------------------------------------------------------------------------
# the parameter shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_shard_then_gather_round_trips_bit_for_bit(param_dtype):
    """Reference pytree (numpy, blocks stacked) and the port's tensors:
    each rank's shard has the layout of launch/specs.py's 2-D rule, and
    the gather gives the whole tree back bit for bit."""
    cfg = ref_get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=96,
        wm_d_ch=80, param_dtype=param_dtype)
    tree = jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(0), cfg))
    shards = [shard_params_2d(tree, r // Q, r % Q, Q) for r in range(Q * Q)]
    s01 = shards[1]                          # i = 0, j = 1
    nb = cfg.n_layers
    assert s01["encoder"]["w"].shape == (64 // Q, 64 // Q)
    assert np.array_equal(s01["encoder"]["w"],
                          tree["encoder"]["w"][32:, :32])   # (mtp, mdom)
    assert np.array_equal(s01["blocks"]["tok_fc1"]["w"],
                          tree["blocks"]["tok_fc1"]["w"][:, :48, 16:])
    assert np.array_equal(s01["blocks"]["tok_fc1"]["b"],
                          tree["blocks"]["tok_fc1"]["b"][:, :48])
    assert np.array_equal(s01["blocks"]["ch_fc1"]["b"],
                          tree["blocks"]["ch_fc1"]["b"][:, 40:])
    assert s01["blocks"]["tok_norm"]["scale"].shape == (nb, 64)
    assert s01["blend"].shape == (4,)
    back = gather_params_2d(shards, Q)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's tensors: shard, gather, and the reference layout again
    port = params_from_numpy(tree, device="cpu")
    pshards = [shard_params_2d(port, r // Q, r % Q, Q) for r in range(Q * Q)]
    assert all(p.data_ptr() != q.data_ptr() for p, q in
               zip(ptree.leaves(pshards[0]), ptree.leaves(port)))
    again = params_to_numpy(gather_params_2d(pshards, Q),
                            bf16_dtype=tree["encoder"]["w"].dtype)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
