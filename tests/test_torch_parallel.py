"""Parity of the port's distributed layer (``orphics_tpu_torch.parallel``,
``mpi``, ``entry.dryrun_multichip``) with the JAX package's, on the CPU.

Every case of ``tests/test_parallel.py`` and the two-process case of
``tests/test_multiprocess.py``, three ways:
- the port on a 4-rank gloo world: one module-scoped fixture starts four
  ``sys.executable -I`` processes running ``RANK_SCRIPT`` (so the ranks
  import neither jax nor this module), joined through a file store, with
  a (4, 1), a (2, 2) and a (1, 4) mesh in the one world; every case runs
  there and each rank writes its outputs to an npz;
- the JAX package on the first four devices of its virtual CPU mesh, in
  this process, on the same numpy inputs;
- the port's one-rank mesh (no process group: the identity collectives)
  and its one-process emulation of the 4-rank split (``runtime.emulate``),
  in this process.
Each test compares one case. The world is bounded: 60 s on every
collective of its process group, ``WORLD_TIMEOUT`` on the ranks, which are
killed if they outlive it. ``dryrun_multichip(4, device="cpu")`` is the
second world.

Tolerances: float64 statistics, one rank against four against a serial
loop, 1e-12 relative (sums in another order); the same per-sample vectors
through JAX's ``SuffStats.add`` and the port's, 1e-12; ``fft2_dist``
against JAX's at float32, 2e-4 absolute and the inverse 2e-6 (those of
``test_parallel.py``); masked bandpowers 2e-4 relative against JAX's and
the numpy bincount (float32 FFTs; B1 sums in float64); ``lens_cov_dist``
(float32 on B8's plain version) 2e-5 of max against JAX's float64, as
``test_torch_nfwfit.py`` holds ``lens_cov``, and 1e-6 of max against the
port's serial ``lens_cov``; the ring-split SHT in float64, 1e-10 against
JAX's; the emulation against the world, 1e-12 relative (the all-reduce's
order), the all-to-all paths bit for bit.

Sizes: as ``test_parallel.py``'s, the masked bandpowers at 4096^2 (on a
(1, 4) mesh here, on (1, 8) there).
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JMesh

import orphics_tpu.parallel as jpar
from orphics_tpu import rect_geometry as jrect
from orphics_tpu.models import pixcov as jpixcov
from orphics_tpu.models import theory as jtheory
from orphics_tpu.ops import alm as jalm, fourier as JF, sht as jsht
from orphics_tpu.ops.windows import get_taper as jget_taper
from orphics_tpu.parallel import fourier as jpfourier, sht as jpsht

import orphics_tpu_torch as tp
from orphics_tpu_torch import entry as tentry, mpi as tmpi
from orphics_tpu_torch.models import nfwfit as tnfwfit
from orphics_tpu_torch.parallel import fourier as tpfourier
from orphics_tpu_torch.parallel import runtime as R
from orphics_tpu_torch.parallel import statistics as TS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
WORLD_TIMEOUT = 150.0
TOL_STATS = 1e-12
TOL_ADD = 1e-12
TOL_FFT = 2e-4
TOL_IFFT = 2e-6
TOL_BP = 2e-4
TOL_LENS = 2e-5
TOL_LENS_SERIAL = 1e-6
TOL_SHT = 1e-10
TOL_EMUL = 1e-12
N_BP = 4096


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# the per-rank functions: shared by the world's ranks (as source text) and
# this process (one-rank mesh, emulation, serial loops)
# ---------------------------------------------------------------------------

CASES = textwrap.dedent("""
import numpy as np
import torch
from orphics_tpu_torch.geometry import Geometry
from orphics_tpu_torch.models import curved
from orphics_tpu_torch.ops import alm as almops, sht
from orphics_tpu_torch.parallel import fourier as PF, runtime as R
from orphics_tpu_torch.parallel import sht as PS, statistics as ST


def sim5(g):
    x = torch.randn(5, generator=g, dtype=torch.float64)
    return {"x": x, "y": 2.0 * x + 1.0}


def sim5_f32(g):
    return {"x": torch.randn(5, generator=g)}


def sim4(g):
    return {"x": torch.randn(4, generator=g, dtype=torch.float64)}


def sim3(g):
    return {"v": torch.randn(3, generator=g, dtype=torch.float64)}


def stack44(g):
    return {"m": torch.randn((4, 4), generator=g, dtype=torch.float64)}


def curved_sim(g):
    lmax = 24
    rings = sht.gauss_legendre_rings(lmax)
    cl = 1.0 / (np.arange(lmax + 1) + 2.0) ** 2
    m = curved.rand_map(g, rings, cl, lmax, dtype=torch.float64,
                        device="cpu")
    return {"cl": almops.alm2cl(sht.map2alm(m, rings, lmax))}


def flat(st, prefix, out):
    for k, v in st.items():
        for f in ("n", "s", "ss", "stack", "nstack"):
            t = getattr(v, f)
            if t is not None:
                out[f"{prefix}/{k}/{f}"] = t.numpy()


def run_cases(m41, m22, m14, inp, ck):
    '''Every distributed case on meshes (4, 1), (2, 2) and (1, 4): a dict
    of host arrays, keyed by case.'''
    out = run_41(m41)
    for chunk in (1, 2):
        flat(R.ensemble_stats(sim4, 11, seed=5, mesh=m41, chunk=chunk),
             f"pad{chunk}", out)
    flat(R.ensemble_stats(sim5_f32, 16, seed=3, mesh=m22), "two", out)
    flat(R.ensemble_stats(curved_sim, 32, seed=7, mesh=m41, chunk=2),
         "curved", out)
    st = ST.Statistics(device="cpu")
    ax = m41.axis("sims")
    st.add("x", torch.as_tensor(inp["rows"][ax.index::ax.size]))
    st.add_stack("m", torch.as_tensor(inp["rows"][ax.index]))
    flat(st.allreduce(ax).state, "allreduce", out)
    # checkpointed ensembles: interrupted and resumed, stacks too
    for tag, kw in (("ck", {}), ("cks", {"stack_fn": stack44})):
        full = R.ensemble_stats_checkpointed(
            sim3, 24, f"{ck}/{tag}_full.npz", every=8, seed=3, mesh=m41,
            **kw)
        path = f"{ck}/{tag}.npz"
        cut = R.ensemble_stats_checkpointed(sim3, 24, path, every=8, seed=3,
                                            mesh=m41, _interrupt_after=1,
                                            **kw)
        out[f"{tag}/interrupted"] = np.asarray(cut is None)
        with np.load(path) as z:
            out[f"{tag}/rounds_done"] = np.asarray(z["rounds_done"])
        res = R.ensemble_stats_checkpointed(sim3, 24, path, every=8, seed=3,
                                            mesh=m41, **kw)
        flat(full, f"{tag}/full", out)
        flat(res, f"{tag}/resumed", out)
        try:
            R.ensemble_stats_checkpointed(sim3, 25, path, every=8, seed=3,
                                          mesh=m41, **kw)
            out[f"{tag}/refused"] = np.asarray(False)
        except ValueError:
            out[f"{tag}/refused"] = np.asarray(True)
    out.update(run_transforms(m22, m14, inp))
    return out


def run_41(m41):
    '''The ensembles on the (4, 1) mesh (also the emulation's cases).'''
    out = {}
    flat(R.ensemble_stats(sim5, 64, seed=3, mesh=m41, chunk=4), "ens", out)
    out["gather"] = R.ensemble(sim3, 16, seed=5, mesh=m41)["v"].numpy()
    return out


def run_transforms(m22, m14, inp):
    '''The grid- and ring-split transforms (also the emulation's cases).'''
    out = run_22(m22, inp)
    out.update(run_14(m14, inp))
    return out


def run_22(m22, inp):
    '''The transforms on the (2, 2) mesh: the pencil FFT with the batch
    over 'sims', the lensed covariance's rows over both axes.'''
    out = {}
    z = PF.fft2_dist(inp["x"], m22, axis="grid", batch_axis="sims")
    out["fft2"] = z.numpy()
    out["ifft2"] = PF.ifft2_dist(z, m22, axis="grid",
                                 batch_axis="sims").numpy()
    ny, nx, dy, dx = inp["lc_geom"]
    geom = Geometry(int(ny), int(nx), float(dy), float(dx))
    out["lens_cov"] = PF.lens_cov_dist(inp["ucov"], inp["alpha"], geom, m22,
                                       lens_order=3,
                                       kbeam=inp["kbeam"]).numpy()
    return out


def run_14(m14, inp):
    '''The transforms on the (1, 4) mesh's grid axis: masked bandpowers,
    the ring-split SHT.'''
    out = {}
    out["mbp"] = PF.masked_bandpowers_dist(
        inp["bp_map"], inp["bp_taper"], inp["bp_dig"],
        int(inp["bp_nbins"]), float(inp["bp_norm"]), m14,
        axis="grid").numpy()
    r40, r32, r24 = (sht.gauss_legendre_rings(l) for l in (40, 32, 24))
    out["m2a"] = PS.map2alm_dist(inp["m40"], r40, 40, m14,
                                 axis="grid").numpy()
    out["a2m"] = PS.alm2map_dist(inp["a40"], r40, 40, m14,
                                 axis="grid").numpy()
    e, b = PS.map2alm_spin_dist(inp["q32"], inp["u32"], r32, 32, m14,
                                axis="grid")
    out["spin_e"], out["spin_b"] = e.numpy(), b.numpy()
    mp = PS.alm2map_dist(inp["a24"], r24, 24, m14, axis="grid")
    out["rt"] = PS.map2alm_dist(mp, r24, 24, m14, axis="grid").numpy()
    return out
""")

RANK_SCRIPT = textwrap.dedent("""
import sys
rank, world, store, inp_path, ck, out_path = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from orphics_tpu_torch.parallel import runtime as R
exec(open({cases!r}).read())
assert R.init_multihost(init_method="file://" + store, world_size=world,
                        rank=rank, device="cpu", timeout=60) == (rank, world)
m41 = R.get_mesh(device="cpu")
m22 = R.get_mesh((2, 2), device="cpu")
m14 = R.get_mesh((1, 4), device="cpu")
with np.load(inp_path) as z:
    inp = {{k: z[k] for k in z.files}}
res = run_cases(m41, m22, m14, inp, ck)
np.savez(out_path, **res)
dist.destroy_process_group()
print("rank", rank, "done", flush=True)
""")

_ns = {}
exec(CASES, _ns)


# ---------------------------------------------------------------------------
# inputs, the world, the one-rank and emulated runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    inp = {"x": rng.standard_normal((2, 64, 64)).astype(np.float32),
           "rows": rng.standard_normal((12, 3))}
    # masked bandpowers at N_BP^2, 0.5', the 12 % taper (JAX's functions)
    geom = jrect(width_arcmin=N_BP * 0.5, px_res_arcmin=0.5)
    edges = np.arange(80, 8000, 400.0)
    dig = np.digitize(geom.modlmap_np(), edges).astype(np.int32)
    dig[dig == len(edges)] = 0
    inp.update(bp_map=np.random.default_rng(1).standard_normal(
        (N_BP, N_BP)).astype(np.float32),
        bp_taper=np.asarray(jget_taper(geom, taper_percent=12.0)[0],
                            np.float32),
        bp_dig=dig, bp_nbins=np.asarray(len(edges) - 1),
        bp_norm=np.asarray(float(geom.area) / float(geom.npix) ** 2))
    # the lensed covariance of test_parallel.py: 16^2, 2', 5' beam
    g = jrect(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    ucov = np.asarray(jpixcov.scov_from_theory(
        g, jtheory.default_theory(), lambda l: JF.gauss_beam(l, 5.0),
        ncomp=1), np.float64)
    ay = 0.3 * g.dy * np.cos(np.linspace(0, 2 * np.pi, g.shape[0]))[:, None] \
        * np.ones(g.shape)
    ax = 0.3 * g.dx * np.sin(np.linspace(0, 2 * np.pi, g.shape[1]))[None, :] \
        * np.ones(g.shape)
    inp.update(ucov=ucov, alpha=np.stack([ay, ax]),
               kbeam=np.array(JF.gauss_beam(g.modlmap(jnp.float64), 5.0)),
               lc_geom=np.array([g.ny, g.nx, g.dy, g.dx], np.float64))
    for lmax in (40, 32, 24):
        shape = jsht.gauss_legendre_rings(lmax).shape
        ls, ms = jalm.lm_indices(lmax)
        r = np.random.default_rng(lmax)
        inp[f"m{lmax}"] = r.standard_normal(shape)
        inp[f"a{lmax}"] = r.standard_normal(ls.size) + 1j * np.where(
            ms == 0, 0.0, r.standard_normal(ls.size))
    inp["q32"] = np.random.default_rng(3).standard_normal(
        jsht.gauss_legendre_rings(32).shape)
    inp["u32"] = np.random.default_rng(4).standard_normal(
        jsht.gauss_legendre_rings(32).shape)
    return inp


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """Every case on the 4-rank gloo world: ``[rank 0's outputs, ...]``."""
    tmp = tmp_path_factory.mktemp("world")
    inp_path = str(tmp / "inputs.npz")
    np.savez(inp_path, **inputs)
    cases = str(tmp / "cases.py")
    with open(cases, "w") as f:
        f.write(CASES)
    script = str(tmp / "rank.py")
    with open(script, "w") as f:
        f.write(RANK_SCRIPT.format(repo=REPO, cases=cases))
    ck = tmp / "ck"
    ck.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-I", script, str(r), str(WORLD),
         str(tmp / "store"), inp_path, str(ck), str(tmp / f"out{r}.npz")],
        env=env, cwd=str(tmp), stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode}):\n"
                    + f.read()[-3000:])
        f.close()
    if any(p.returncode != 0 for p in procs):
        pytest.fail("the 4-rank world failed or timed out:\n"
                    + "\n".join(text))
    outs = []
    for r in range(WORLD):
        with np.load(tmp / f"out{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


@pytest.fixture(scope="module")
def jmeshes():
    """The JAX package's (2, 2) and (1, 4) meshes of the first four virtual
    CPU devices."""
    devs = np.array(jax.devices()[:4])
    return {"22": JMesh(devs.reshape(2, 2), ("sims", "grid")),
            "14": JMesh(devs.reshape(1, 4), ("sims", "grid"))}


@pytest.fixture(scope="module")
def emulated(inputs):
    """The ensembles and transforms on the one-process emulation of the
    (4, 1), (2, 2) and (1, 4) splits (one thread a rank): rank 0's
    outputs, and whether every rank returned the same."""
    outs22 = R.emulate(lambda m: _ns["run_22"](m, inputs), (2, 2),
                       device="cpu")
    outs14 = R.emulate(lambda m: _ns["run_14"](m, inputs), (1, 4),
                       device="cpu")
    outs41 = R.emulate(_ns["run_41"], (4, 1), device="cpu")
    res = {}
    same = True
    for outs in (outs22, outs14, outs41):
        for k in outs[0]:
            res[k] = outs[0][k]
            same &= all(np.array_equal(o[k], outs[0][k]) for o in outs)
    res["_same"] = same
    return res


def _one_rank_mesh():
    return R.get_mesh(device="cpu")


@pytest.fixture(scope="module")
def one_rank(inputs):
    """The transforms on the one-rank mesh (identity collectives)."""
    one = _one_rank_mesh()
    return _ns["run_transforms"](one, one, inputs)


def _suff(out, prefix, label):
    return {f: out[f"{prefix}/{label}/{f}"] for f in ("n", "s", "ss")
            if f"{prefix}/{label}/{f}" in out}


def _serial_stats(fn, nsims, seed, label):
    x = torch.stack([fn(R.task_generator(seed, i, "cpu"))[label]
                     for i in range(nsims)])
    st = TS.SuffStats.zeros(x.shape[1], dtype=x.dtype, device="cpu").add(x)
    return {"n": st.n.numpy(), "s": st.s.numpy(), "ss": st.ss.numpy()}


# ---------------------------------------------------------------------------
# SuffStats, Statistics, the npz format (no world)
# ---------------------------------------------------------------------------

def test_mpi_distribute_policy():
    """Remainder goes to the last ranks (reference orphics/mpi.py:83);
    return signature is the reference's (num_each, task_dist) tuple."""
    counts, chunks = R.mpi_distribute(10, 4)
    assert list(counts) == [2, 2, 3, 3]
    assert [len(c) for c in chunks] == [2, 2, 3, 3]
    assert sum(chunks, []) == list(range(10))
    for n, c in ((10, 4), (8, 4), (7, 7), (3, 5)):
        a, b = R.mpi_distribute(n, c, allow_empty=True), \
            jpar.mpi_distribute(n, c, allow_empty=True)
        assert list(a[0]) == list(b[0]) and a[1] == b[1]


def test_suffstats_mean_cov_closed_form():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((500, 7))
    st = TS.SuffStats.zeros(7, dtype=torch.float64, device="cpu").add(
        torch.as_tensor(x))
    np.testing.assert_allclose(st.mean().numpy(), x.mean(axis=0),
                               rtol=1e-10)
    np.testing.assert_allclose(st.cov().numpy(), np.cov(x.T, ddof=1),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(st.var().numpy(), x.var(axis=0, ddof=1),
                               rtol=1e-8)
    np.testing.assert_allclose(st.std().numpy(), x.std(axis=0, ddof=1),
                               rtol=1e-8)
    np.testing.assert_allclose(st.err().numpy(),
                               x.std(axis=0, ddof=1) / np.sqrt(500),
                               rtol=1e-8)
    np.testing.assert_allclose(st.corr().numpy(), np.corrcoef(x.T),
                               rtol=1e-7, atol=1e-10)


def test_suffstats_merge_equals_concat():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((100, 3))
    b = rng.standard_normal((37, 3))
    z = lambda: TS.SuffStats.zeros(3, dtype=torch.float64, device="cpu")
    merged = z().add(torch.as_tensor(a)).merge(z().add(torch.as_tensor(b)))
    both = z().add(torch.as_tensor(np.vstack([a, b])))
    np.testing.assert_allclose(merged.cov().numpy(), both.cov().numpy(),
                               rtol=1e-10)
    assert float(merged.n) == 137


def test_suffstats_add_matches_jax():
    """The same per-sample vectors, stacks and 0/1 weights through JAX's
    SuffStats and the port's (float64, 1e-12)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 4))
    w = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0], np.float64)
    arr = rng.standard_normal((9, 3, 5))
    j = jpar.SuffStats.zeros(4, dtype=jnp.float64).add(jnp.asarray(x[:4])) \
        .add(jnp.asarray(x), w=jnp.asarray(w))
    t = TS.SuffStats.zeros(4, dtype=torch.float64, device="cpu").add(
        torch.as_tensor(x[:4])).add(torch.as_tensor(x), w=w)
    for f in ("n", "s", "ss"):
        assert _rel(getattr(t, f).numpy(), getattr(j, f)) <= TOL_ADD, f
    for fn in ("mean", "cov", "var", "std", "err", "corr"):
        assert _rel(getattr(t, fn)().numpy(), getattr(j, fn)()) <= TOL_ADD
    js = jpar.statistics.SuffStats.zeros_stack((3, 5), jnp.float64) \
        .add_stack(jnp.asarray(arr), w=jnp.asarray(w)).add_stack(
            jnp.asarray(arr[0]))
    ts = TS.SuffStats.zeros_stack((3, 5), torch.float64, "cpu").add_stack(
        torch.as_tensor(arr), w=w).add_stack(torch.as_tensor(arr[0]))
    assert _rel(ts.stack_mean().numpy(), js.stack_mean()) <= TOL_ADD
    assert float(ts.nstack) == float(js.nstack) == 7.0


def test_statistics_roundtrip_save_load(tmp_path):
    rng = np.random.default_rng(2)
    s = TS.Statistics(device="cpu")
    for _ in range(5):
        s.extend("p1d", rng.standard_normal((8, 4)))
    s.add_stack("m", rng.standard_normal((6, 6)))
    fname = str(tmp_path / "red.npz")
    s.save_reduced(fname)
    s2 = TS.Statistics.load_reduced(fname, device="cpu")
    for fn in ("mean", "cov"):
        np.testing.assert_array_equal(getattr(s2, fn)("p1d").numpy(),
                                      getattr(s, fn)("p1d").numpy())
    np.testing.assert_array_equal(s2.stack_mean("m").numpy(),
                                  s.stack_mean("m").numpy())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_read_across_packages(writer, tmp_path):
    """``save_reduced`` of one package is ``load_reduced`` of the other:
    the same ``{label}__{field}`` keys, bit-equal statistics."""
    rng = np.random.default_rng(3)
    x, m = rng.standard_normal((8, 4)), rng.standard_normal((5, 5))
    js, ts = jpar.Statistics(), TS.Statistics(device="cpu")
    js.add("p__1d", jnp.asarray(x))
    js.add_stack("m", jnp.asarray(m))
    ts.add("p__1d", x)
    ts.add_stack("m", m)
    fname = str(tmp_path / "red.npz")
    (js if writer == "jax" else ts).save_reduced(fname)
    if writer == "jax":
        back = TS.Statistics.load_reduced(fname, device="cpu")
        got = TS.state_to_arrays(back.state)
        want = TS.state_to_arrays(ts.state)
    else:
        back = jpar.Statistics.load_reduced(fname)
        got = jpar.statistics.state_to_arrays(back.state)
        want = jpar.statistics.state_to_arrays(js.state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= TOL_ADD, k


def test_get_stats_and_stats_dump(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, 3))
    d = TS.get_stats(x, device="cpu")
    jd = jpar.get_stats(jnp.asarray(x))
    for k in ("mean", "cov", "covmean", "err", "errmean", "corr"):
        assert _rel(d[k].numpy(), jd[k]) <= TOL_ADD, k
    assert d["N"] == jd["N"] == 50
    s = TS.Stats(device="cpu")
    for row in x:
        s.add_to_stats("v", row)
    s.add_to_stack("m", x[:3])
    st = s.get_stats()["v"]
    assert _rel(st["errmean"], x.std(axis=0, ddof=1) / np.sqrt(50)) <= 1e-10
    s.dump(str(tmp_path / "d"))
    back = TS.load_stats(str(tmp_path / "d"))
    assert _rel(back.stats["v"]["mean"], x.mean(axis=0)) <= 1e-10
    assert _rel(back.stacks["m"], x[:3]) <= 1e-15


# ---------------------------------------------------------------------------
# the mesh runtime
# ---------------------------------------------------------------------------

def test_one_rank_mesh_and_mpi_facade():
    """With no process group the mesh is one rank and its collectives are
    the identity (the fakeMpiComm degradation); the mpi facade's serial
    comm."""
    m = R.get_mesh(device="cpu")
    assert m.shape == {"sims": 1, "grid": 1} and m.size == 1
    t = torch.arange(6.0).reshape(2, 3)
    for ax in (m.axis("sims"), m.axis(("sims", "grid"))):
        assert ax.index == 0 and ax.size == 1
        assert ax.all_reduce(t) is t and ax.all_gather(t, 0) is t
        assert ax.all_to_all(t, 1, 0) is t
    with pytest.raises(ValueError, match="init_multihost"):
        R.get_mesh((2, 2), device="cpu")
    assert tmpi.comm.Get_size() == 1 and tmpi.rank == 0
    assert tmpi.ensemble_stats is R.ensemble_stats


def test_collectives_refuse_another_device():
    """A collective of a card mesh takes no host tensor (and the reverse):
    it raises before any transport, nothing is copied across."""
    ax = R._GroupAxis(None, 0, 2, torch.device("cuda"))
    for call in (lambda: ax.all_reduce(torch.ones(4)),
                 lambda: ax.all_to_all(torch.ones(4, 4), 1, 0),
                 lambda: ax.all_gather(torch.ones(4), 0)):
        with pytest.raises(ValueError, match="cuda mesh"):
            call()
    one = R.get_mesh(device="cpu")
    with pytest.raises(ValueError, match="for a mesh on"):
        tpfourier.fft2_dist(torch.zeros((4, 4), device="meta"), one)


def test_emulation_propagates_a_failing_rank():
    """A rank that raises ends the emulation with its exception; the others
    waiting at a collective are released, not left hanging."""
    def body(mesh):
        if mesh.axis("grid").index == 1:
            raise KeyError("rank 1")
        return mesh.axis("grid").all_reduce(torch.ones(2))

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 1"):
        R.emulate(body, (1, 4), device="cpu", timeout=30.0)
    assert time.monotonic() - t0 < 20.0


def test_task_generators_and_distribute():
    """Each task's stream depends on (seed, task) only; ``distribute`` lists
    the seeds rank-major."""
    a = torch.randn(4, generator=R.task_generator(3, 7, "cpu"))
    b = torch.randn(4, generator=R.task_generator(3, 7, "cpu"))
    c = torch.randn(4, generator=R.task_generator(3, 8, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    mesh, seeds = R.distribute(10, seed=3, mesh=R.get_mesh(device="cpu"))
    assert seeds.shape == (1, 10)
    g = torch.Generator().manual_seed(int(seeds[0, 7]))
    assert torch.equal(torch.randn(4, generator=g), a)


class TestInitMultihost:
    """init_multihost: the reference's MPI-or-fake world bootstrap
    (orphics/mpi.py:62-74) on torch.distributed.init_process_group."""

    ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

    def _clear(self, monkeypatch):
        for v in self.ENV:
            monkeypatch.delenv(v, raising=False)

    def test_single_process_noop(self, monkeypatch):
        self._clear(monkeypatch)
        calls = []
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda *a, **kw: calls.append(kw))
        assert R.init_multihost(device="cpu") == (0, 1)
        assert calls == []           # fakeMpiComm degradation: no init

    def test_torchrun_env_triggers_initialize(self, monkeypatch):
        self._clear(monkeypatch)
        for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1234"),
                     ("RANK", "2"), ("WORLD_SIZE", "4")):
            monkeypatch.setenv(k, v)
        calls = []
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda *a, **kw: calls.append((a, kw)))
        assert R.init_multihost(device="cpu") == (2, 4)
        assert len(calls) == 1
        (backend,), kw = calls[0]
        assert backend == "gloo" and kw["init_method"] == "env://"
        assert (kw["rank"], kw["world_size"]) == (2, 4)

    def test_idempotent_on_reinit(self, monkeypatch):
        """A process already in a world gets its rank and size back, and no
        second initialization is tried."""
        self._clear(monkeypatch)

        def boom(*a, **kw):
            raise RuntimeError("trying to initialize the default process "
                               "group twice: already initialized")

        monkeypatch.setattr(torch.distributed, "init_process_group", boom)
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        assert R.init_multihost(init_method="file:///nonexistent/store",
                                world_size=2, rank=1, device="cpu") == (1, 2)

    def test_real_errors_propagate(self, monkeypatch):
        self._clear(monkeypatch)

        def boom(*a, **kw):
            raise RuntimeError("connection refused")

        monkeypatch.setattr(torch.distributed, "init_process_group", boom)
        with pytest.raises(RuntimeError, match="connection refused"):
            R.init_multihost(init_method="file:///nonexistent/store",
                             world_size=2, rank=0, device="cpu")


# ---------------------------------------------------------------------------
# ensembles on the world: 4 ranks, 1 rank, the serial loop
# ---------------------------------------------------------------------------

def test_ranks_agree(world):
    """What every rank returns is replicated: rank r's outputs equal rank
    0's bit for bit."""
    for r in range(1, WORLD):
        assert sorted(world[r]) == sorted(world[0])
        for k in world[0]:
            np.testing.assert_array_equal(world[r][k], world[0][k], err_msg=k)


def test_ensemble_stats_four_ranks_one_rank_serial(world):
    one = R.ensemble_stats(_ns["sim5"], 64, seed=3,
                           mesh=R.get_mesh(device="cpu"), chunk=4)
    for label in ("x", "y"):
        got = _suff(world[0], "ens", label)
        ser = _serial_stats(_ns["sim5"], 64, 3, label)
        assert float(got["n"]) == 64
        for f in ("s", "ss"):
            assert _rel(got[f], ser[f]) <= TOL_STATS, (label, f)
            assert _rel(getattr(one[label], f).numpy(), ser[f]) \
                <= TOL_STATS, (label, f)
    xs = np.stack([_ns["sim5"](R.task_generator(3, i, "cpu"))["x"].numpy()
                   for i in range(64)])
    mean_y = world[0]["ens/y/s"] / world[0]["ens/y/n"]
    assert _rel(mean_y, 2 * xs.mean(axis=0) + 1) <= 1e-12


@pytest.mark.parametrize("chunk", [1, 2])
def test_ensemble_stats_padding_excluded(world, chunk):
    """nsims = 11 on 4 ranks is not a multiple of ranks x chunk: the
    padding tasks carry no weight (a rank with none of the 11 runs one
    at weight 0)."""
    got = _suff(world[0], f"pad{chunk}", "x")
    assert float(got["n"]) == 11
    ser = _serial_stats(_ns["sim4"], 11, 5, "x")
    for f in ("s", "ss"):
        assert _rel(got[f], ser[f]) <= TOL_STATS, f


def test_two_process_ensemble_matches_single_process(world):
    """tests/test_multiprocess.py's case: the sims axis of the (2, 2) mesh
    spans two processes; the reduced moments equal the one-process run's
    (float32 draws, 1e-6 as there)."""
    got = _suff(world[0], "two", "x")
    one = R.ensemble_stats(_ns["sim5_f32"], 16, seed=3,
                           mesh=R.get_mesh(device="cpu"))["x"]
    assert float(got["n"]) == 16
    np.testing.assert_allclose(got["s"] / got["n"], one.mean().numpy(),
                               rtol=0, atol=1e-6)
    cov = (got["ss"] - np.outer(got["s"], got["s"]) / got["n"]) \
        / (got["n"] - 1)
    np.testing.assert_allclose(cov, one.cov().numpy(), rtol=0, atol=1e-6)


def test_ensemble_gather(world):
    want = np.stack([_ns["sim3"](R.task_generator(5, i, "cpu"))["v"].numpy()
                     for i in range(16)])
    np.testing.assert_array_equal(world[0]["gather"], want)
    one = R.ensemble(_ns["sim3"], 16, seed=5, mesh=R.get_mesh(device="cpu"))
    np.testing.assert_array_equal(one["v"].numpy(), want)


def test_statistics_allreduce(world, inputs):
    """``Statistics.allreduce(mesh.axis("sims"))`` sums each rank's rows
    and stacks: the statistics of all rows."""
    all_rows = inputs["rows"]
    st = TS.SuffStats.zeros(3, dtype=torch.float64, device="cpu").add(
        torch.as_tensor(all_rows))
    got = _suff(world[0], "allreduce", "x")
    assert float(got["n"]) == 12
    assert _rel(got["ss"], st.ss.numpy()) <= TOL_STATS
    assert _rel(world[0]["allreduce/m/stack"], all_rows[:4].sum(0)) \
        <= TOL_STATS


def test_curved_mc_spectrum_recovery(world):
    """TestCurvedEnsemble on the port: rand_map -> map2alm -> alm2cl over
    the sims axis (lmax 24, 32 sims); the draws differ from JAX's (same
    law, another stream)."""
    lmax = 24
    cl = 1.0 / (np.arange(lmax + 1) + 2.0) ** 2
    got = _suff(world[0], "curved", "cl")
    assert float(got["n"]) == 32
    ratio = (got["s"] / got["n"])[3:] / cl[3:]
    assert abs(ratio.mean() - 1.0) < 0.1
    assert np.all(np.isfinite(got["ss"]))


@pytest.mark.parametrize("tag", ["ck", "cks"])
def test_checkpoint_resume_bitwise(world, tag):
    """An interrupted run resumed equals the uninterrupted run bit for bit,
    stacks included (``cks``)."""
    out = world[0]
    assert bool(out[f"{tag}/interrupted"])
    assert int(out[f"{tag}/rounds_done"]) == 1
    keys = [k for k in out if k.startswith(f"{tag}/full/")]
    assert any(k.endswith("/ss") for k in keys)
    if tag == "cks":
        assert float(out["cks/full/m/nstack"]) == 24
    for k in keys:
        np.testing.assert_array_equal(
            out[k], out[k.replace("/full/", "/resumed/")], err_msg=k)


def test_checkpoint_refuses_other_arguments(world):
    assert bool(world[0]["ck/refused"]) and bool(world[0]["cks/refused"])


# ---------------------------------------------------------------------------
# the grid- and ring-split transforms against JAX's
# ---------------------------------------------------------------------------

def test_fft2_dist_both_axes(world, inputs, jmeshes):
    x = inputs["x"]
    z = world[0]["fft2"]
    jz = np.asarray(jpfourier.fft2_dist(x, jmeshes["22"], axis="grid",
                                        batch_axis="sims"))
    np.testing.assert_allclose(z, jz, rtol=0, atol=TOL_FFT)
    np.testing.assert_allclose(z, np.fft.fft2(x), rtol=0, atol=TOL_FFT)
    np.testing.assert_allclose(world[0]["ifft2"].real, x, atol=TOL_IFFT)


def test_masked_bandpowers_dist(world, inputs, jmeshes):
    inp = inputs
    nbins, norm = int(inp["bp_nbins"]), float(inp["bp_norm"])
    bp = world[0]["mbp"]
    assert bp.shape == (nbins,)
    jbp = np.asarray(jpfourier.masked_bandpowers_dist(
        inp["bp_map"], inp["bp_taper"], inp["bp_dig"], nbins, norm,
        jmeshes["14"], axis="grid"))
    np.testing.assert_allclose(bp, jbp, rtol=TOL_BP)
    dig = inp["bp_dig"]
    z = np.fft.fft2((inp["bp_map"] * inp["bp_taper"]).astype(np.complex64))
    p = (np.abs(z) ** 2).astype(np.float64) * norm
    sums = np.bincount(dig.ravel(), weights=p.ravel(), minlength=nbins + 1)
    cnts = np.bincount(dig.ravel(), minlength=nbins + 1)
    np.testing.assert_allclose(bp, sums[1:] / np.maximum(cnts[1:], 1),
                               rtol=TOL_BP)


def test_lens_cov_dist(world, inputs, jmeshes):
    inp = inputs
    g = jrect(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    got = world[0]["lens_cov"]
    want = np.asarray(jpfourier.lens_cov_dist(
        jnp.asarray(inp["ucov"]), jnp.asarray(inp["alpha"]), g,
        jmeshes["22"], lens_order=3, kbeam=jnp.asarray(inp["kbeam"])))
    assert got.dtype == np.float32 and got.shape == inp["ucov"].shape
    assert _rel(got, want) <= TOL_LENS
    tg = tp.rect_geometry(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    ser = tnfwfit.lens_cov(inp["ucov"], inp["alpha"], tg, lens_order=3,
                           kbeam=inp["kbeam"], device="cpu").numpy()
    assert _rel(got, ser) <= TOL_LENS_SERIAL


@pytest.mark.parametrize("case", ["m2a", "a2m", "rt", "spin"])
def test_ring_split_sht(world, inputs, jmeshes, case):
    """map2alm_dist, alm2map_dist, their roundtrip and map2alm_spin_dist
    on the (1, 4) mesh's grid axis (41 -> 44, 25 -> 28, 33 -> 36 padded
    rings) against JAX's on the same split."""
    m14 = jmeshes["14"]
    out = world[0]
    if case == "m2a":
        rings = jsht.gauss_legendre_rings(40)
        want = jpsht.map2alm_dist(jnp.asarray(inputs["m40"]), rings, 40,
                                  m14, axis="grid")
        pairs = [(out["m2a"], want)]
    elif case == "a2m":
        rings = jsht.gauss_legendre_rings(40)
        want = jpsht.alm2map_dist(jnp.asarray(inputs["a40"]), rings, 40,
                                  m14, axis="grid")
        pairs = [(out["a2m"], want)]
    elif case == "rt":
        rings = jsht.gauss_legendre_rings(24)
        jm = jpsht.alm2map_dist(jnp.asarray(inputs["a24"]), rings, 24, m14,
                                axis="grid")
        want = jpsht.map2alm_dist(jm, rings, 24, m14, axis="grid")
        pairs = [(out["rt"], want), (out["rt"], inputs["a24"])]
    else:
        rings = jsht.gauss_legendre_rings(32)
        e, b = jpsht.map2alm_spin_dist(jnp.asarray(inputs["q32"]),
                                       jnp.asarray(inputs["u32"]), rings,
                                       32, m14, axis="grid")
        pairs = [(out["spin_e"], e), (out["spin_b"], b)]
    for got, want in pairs:
        assert np.max(np.abs(got - np.asarray(want))) <= TOL_SHT


# ---------------------------------------------------------------------------
# the one-process emulation and the one-rank mesh against the world
# ---------------------------------------------------------------------------

_TRANSFORMS = ("fft2", "ifft2", "mbp", "lens_cov", "m2a", "a2m", "rt",
               "spin_e", "spin_b")


@pytest.mark.parametrize("key", _TRANSFORMS + ("ens/x/ss", "ens/y/s",
                                               "gather"))
def test_emulation_matches_world(world, emulated, key):
    """The S-rank split run as threads of this process equals the 4-rank
    world: bit for bit where only all-to-alls and all-gathers move data,
    to 1e-12 where an all-reduce sums in another order."""
    assert emulated["_same"]
    got, want = emulated[key], world[0][key]
    if key in ("fft2", "ifft2", "a2m", "gather"):
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= TOL_EMUL


@pytest.mark.parametrize("key", _TRANSFORMS)
def test_one_rank_matches_world(world, one_rank, key):
    """The one-rank mesh (one block, identity collectives) against the
    4-rank split: the same transform up to the summation order of each
    FFT and sum (float32: 1e-6 of max; float64: 1e-12)."""
    tol = 1e-6 if world[0][key].dtype in (np.float32, np.complex64) \
        else 1e-12
    assert _rel(one_rank[key], world[0][key]) <= tol


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_multichip_cpu_four_ranks():
    """``entry.dryrun_multichip(4, device="cpu")``: four gloo processes run
    the legs of ``__graft_entry__.py:144-260``, each held to its serial
    counterpart (the second world of this file)."""
    tentry.dryrun_multichip(4, device="cpu", timeout=WORLD_TIMEOUT)


def test_dryrun_multichip_one_rank_in_process():
    """``dryrun_multichip(1, device="cpu")`` runs the legs in its calling
    process on a one-rank gloo group and leaves no group behind. The caller
    is a ``-I`` process of its own, so no group is started in this one."""
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "from orphics_tpu_torch import entry\n"
            "entry.dryrun_multichip(1, device='cpu', timeout=60.0)\n"
            "assert not torch.distributed.is_initialized()\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    r = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                       capture_output=True, text=True, timeout=WORLD_TIMEOUT)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]


def test_dryrun_multichip_needs_the_cards():
    """More ranks than cards raises and names ``device="cpu"`` (with no
    card at all, the device rule raises the same)."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tentry.dryrun_multichip(max(2, torch.cuda.device_count() + 1))
