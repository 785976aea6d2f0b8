"""The port's satellite-axis mesh (`repro_torch.core.mesh` and the `mesh=`
of `SimulationEngine`, `score_candidates` and `ReplanService`) against the
port without a mesh and against the reference.

The mesh is a performance feature, so every test is an identity test, as
tests/test_sweep_and_mesh.py's are: a sharded run gives the trajectory of
`mesh=None`, integers exactly and floats bit for bit (a sharded run
changes no float operation, it splits the satellite axis of integer
transitions), and its integers are the reference's unsharded run's. A
world of one runs in-process on a gloo group (`sim_mesh(device="cpu")`);
a world of 8 gloo ranks runs in a subprocess (`torch.multiprocessing.
spawn` over a `FileStore`, one thread a rank) at a K the mesh does not
divide, so the padding is exercised. The ranks import this module for
its port-only helpers, so the reference is imported inside the tests
(`_reference`)."""
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import connectivity as TCN
from repro_torch.core import faults as TFT
from repro_torch.core import isl as TI
from repro_torch.core import mesh as TM
from repro_torch.core import staleness as TS
from repro_torch.core.scheduler import FedSpaceScheduler
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.utility import RandomForestRegressor, n_features
from repro_torch.fl.engine import EngineConfig, SimulationEngine
from repro_torch.fl.replan import ReplanService

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _reference():
    """The reference's modules the tests hold the port against."""
    import repro.core.connectivity as RCN
    import repro.core.faults as RFT
    import repro.core.isl as RI
    import repro.core.mesh as RM
    import repro.core.staleness as RS
    from repro.core.scheduler import make_scheduler
    from repro.fl.engine import EngineConfig, SimulationEngine
    from tests.test_protocol_lockstep import _StubAdapter
    return dict(CN=RCN, FT=RFT, ISL=RI, M=RM, SS=RS, make=make_scheduler,
                EC=EngineConfig, SE=SimulationEngine, Stub=_StubAdapter)


class StubAdapter:
    """A two-parameter model whose loss has zero gradient: client training
    changes nothing, so a run isolates the protocol (tests/
    test_torch_faults.py's, kept here so that the spawned ranks import
    the port alone)."""

    def __init__(self, K, device="cpu"):
        self.clients = list(range(K))
        self.device = torch.device(device)

    def init(self, gen):
        return {"w": torch.zeros(2, device=self.device)}

    def loss(self, params, batch):
        return (params["w"] * 0.0).sum(-1) + batch[0].sum(-1) * 0.0

    def client_batch(self, ci, round_rng, batch_size, num_batches):
        return (torch.zeros((num_batches, 1), device=self.device),)

    def accuracy(self, params):
        return 0.0

    def val_loss(self, params):
        return 0.0


class _Mesh:
    """A mesh of `n` devices as both packages' padding reads it."""

    def __init__(self, n):
        self.n, self.shape, self.axis_names = n, {"sat": n}, ("sat",)

    def size(self):
        return self.n


# ---------------------------------------------------------------------------
# pure functions


@pytest.mark.parametrize("n", [1, 3, 8])
def test_padded_size_matches_the_reference(n):
    RM = _reference()["M"]
    for K in (1, 7, 8, 10, 36, 191, 1000):
        got = TM.padded_size(K, _Mesh(n))
        assert got == RM.padded_size(K, _Mesh(n)) and got % n == 0


@pytest.mark.parametrize("shape,axis,total,fill", [
    ((5,), -1, 8, 0), ((3, 5), -1, 8, False), ((3, 5), 0, 6, 7),
    ((2, 3, 5), -1, 5, 0), ((4, 6), -1, 9, -1)])
def test_pad_axis_matches_the_reference(shape, axis, total, fill):
    RM = _reference()["M"]
    x = np.random.default_rng(0).integers(-1, 5, shape).astype(np.int32)
    for arr in (x, x > 1):
        got = TM.pad_axis(arr, total, axis=axis, fill=fill)
        want = RM.pad_axis(arr, total, axis=axis, fill=fill)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("progress,relay,batch", [
    (False, False, ()), (True, False, ()), (True, True, ()),
    (False, True, (3,))])
def test_pad_state_matches_the_reference(progress, relay, batch):
    import jax.numpy as jnp
    ref = _reference()
    RM, RS = ref["M"], ref["SS"]
    rng = np.random.default_rng(1)
    K, total = 10, 16

    def col(lo, hi):
        return rng.integers(lo, hi, batch + (K,)).astype(np.int32)
    cols = [col(-1, 4), col(-1, 4), col(-1, 4),
            col(0, 3) if progress else None, col(0, 3) if relay else None]
    got = TM.pad_state(TS.SatState(*(None if c is None else
                                     torch.as_tensor(c) for c in cols)),
                       total)
    want = RM.pad_state(RS.SatState(*(None if c is None else
                                      jnp.asarray(c) for c in cols)), total)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert tuple(g.shape) == batch + (total,)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_collectives_are_the_identity_without_an_axis():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    before = dict(TM.collective_counts)
    for f in (TM.psum, TM.pmax, TM.all_gather):
        assert f(x, None) is x
    assert dict(TM.collective_counts) == before


def test_sim_mesh_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.sim_mesh()
    assert not dist.is_initialized()


def test_engine_rejects_a_mesh_on_another_device_type():
    class CardMesh(_Mesh):
        device_type = "cuda"
    C = np.ones((4, 3), bool)
    with pytest.raises(ValueError, match="mesh on cuda"):
        SimulationEngine(C, StubAdapter(3), make_scheduler("sync"),
                         device="cpu", mesh=CardMesh(1))


# ---------------------------------------------------------------------------
# a world of one, in-process


@pytest.fixture
def mesh1():
    """A gloo mesh of one rank, destroyed after the test, so no default
    group outlives it in the worker."""
    assert not dist.is_initialized()
    mesh = TM.sim_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_sim_mesh_clips_above_the_world_and_refuses_below(mesh1):
    assert TM.mesh_size(TM.sim_mesh(4, device="cpu")) == 1
    assert TM.mesh_size(TM.sim_mesh(1, device="cpu")) == 1
    with pytest.raises(ValueError, match="below the world size 1"):
        TM.sim_mesh(0, device="cpu")


def _rand_world(K, I, seed):
    return np.random.default_rng(seed).random((I, K)) < 0.3


def _world1(CN, FT, K=10, I=48):
    """tests/test_sweep_and_mesh.py::test_mesh_single_device_identity's
    world and one package's engine keywords of its plain, budget and churn
    variants."""
    C = _rand_world(K, I, 6)
    grants = (np.random.default_rng(7).integers(1, 4, C.shape)
              .astype(np.int32)) * C
    budget = CN.LinkBudget(visible=C, served=C,
                           assign=np.where(C, 0, -1).astype(np.int32),
                           grants=grants, need_up=2, need_dn=1)
    trace = FT.fault_trace(FT.FaultConfig(
        deorbit=FT.random_churn(K, I, 0.25, seed=8)), I, K=K)
    return C, {"plain": {}, "budget": {"link_budget": budget},
               "faults": {"faults": trace}}


def _columns(eng, res):
    """Every integer of a finished port run, and its state columns."""
    return ([getattr(eng, f) for f in ("version", "pending",
                                       "buffered_base", "transfer_progress",
                                       "relay_units")],
            eng.ig, res.staleness_hist.tolist(), res.summary())


def _same(a, b):
    (ca, iga, ha, sa), (cb, igb, hb, sb) = a, b
    for x, y in zip(ca, cb):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert (iga, ha, sa) == (igb, hb, sb)


def _same_as_reference(got, reng, rres, tag):
    """A port run's `_columns` against a finished reference run: every
    state column, `ig`, the histogram and the counters exactly."""
    cols, ig, hist, summary = got
    for f, x in zip(("version", "pending", "buffered_base",
                     "transfer_progress", "relay_units"), cols):
        want = getattr(reng, f)
        assert (x is None) == (want is None), (tag, f)
        if x is not None:
            np.testing.assert_array_equal(x, np.asarray(want),
                                          err_msg=f"{tag} {f}")
    assert ig == reng.ig and hist == rres.staleness_hist.tolist(), tag
    assert (summary["global_updates"], summary["aggregated_gradients"],
            summary["idle_connections"], summary["total_connections"]) == (
        rres.num_global_updates, rres.num_aggregated_gradients,
        rres.idle_connections, rres.total_connections), tag


@pytest.mark.parametrize("case", ["plain", "budget", "faults"])
def test_mesh_single_device_identity(mesh1, case):
    """A mesh of one rank: the fast loop's scans run sharded with their
    collectives, the host loop on the padded state; both give the
    `mesh=None` run bit for bit, whose integers are the reference's."""
    ref = _reference()
    C, cases = _world1(TCN, TFT)
    tkw = cases[case]
    K, I = C.shape[1], C.shape[0]
    runs = {}
    for label, mesh, fast in (("none", None, True), ("mesh", mesh1, True),
                              ("mesh_host", mesh1, False)):
        eng = SimulationEngine(C, StubAdapter(K),
                               make_scheduler("fedbuff", M=4),
                               EngineConfig(eval_every=I + 1,
                                            fast_loop=fast),
                               device="cpu", mesh=mesh, **tkw)
        runs[label] = (eng, eng.run())
    before = dict(TM.collective_counts)
    eng = SimulationEngine(C, StubAdapter(K), make_scheduler("fedbuff", M=4),
                           EngineConfig(eval_every=I + 1), device="cpu",
                           mesh=mesh1, **tkw)
    eng.run()
    assert TM.collective_counts["psum"] > before.get("psum", 0)
    assert TM.collective_counts["all_gather"] > before.get("all_gather", 0)
    for label in ("mesh", "mesh_host"):
        _same(_columns(*runs[label]), _columns(*runs["none"]))
    reng = ref["SE"](C, ref["Stub"](K), ref["make"]("fedbuff", M=4),
                     ref["EC"](eval_every=I + 1),
                     **_world1(ref["CN"], ref["FT"])[1][case])
    rres = reng.run()
    _same_as_reference(_columns(*runs["none"]), reng, rres, case)


def _forest(seed=0):
    rng = np.random.default_rng(seed)
    return RandomForestRegressor(n_trees=2, max_depth=3).fit(
        rng.random((30, n_features(8))).astype(np.float32),
        rng.random(30).astype(np.float32))


def test_mesh_single_device_fedspace_and_service(mesh1):
    """FedSpace's re-plans through the engine under a mesh of one (each
    re-plan a sharded `score_candidates`) give the unsharded run, and a
    `ReplanService(mesh=...)` answers every request with a sharded full
    rescan (reason "mesh", nothing cached) equal to the unsharded full
    answer."""
    K, I = 10, 48
    C = _rand_world(K, I, 9)
    rf = _forest()
    out = []
    for mesh in (None, mesh1):
        sched = FedSpaceScheduler(rf, I0=12, n_min=2, n_max=5,
                                  num_candidates=64, seed=4)
        eng = SimulationEngine(C, StubAdapter(K), sched,
                               EngineConfig(eval_every=I + 1),
                               device="cpu", mesh=mesh)
        out.append(_columns(eng, eng.run()))
        assert sched.mesh is mesh
    _same(out[0], out[1])
    assert out[0][3]["global_updates"] > 0
    svc = ReplanService(rf, I0=12, num_candidates=64, n_min=2, n_max=5,
                        min_pool=8, mesh=mesh1)
    state = TS.bootstrap_state(K, device="cpu")
    for i in range(3):
        got = svc.replan(i, C[i:i + 12], state, 0, 0.5,
                         rng=np.random.default_rng(30 + i))
        want = ReplanService(rf, I0=12, num_candidates=64, n_min=2,
                             n_max=5, min_pool=8).replan(
            i, C[i:i + 12], state, 0, 0.5,
            rng=np.random.default_rng(30 + i))
        np.testing.assert_array_equal(got, want)
        assert (svc.last_mode, svc.last_reason) == ("full", "mesh")
        assert svc.pool is None
    assert svc.stats == {"full": 3, "delta": 0, "invalidated": {}}


# ---------------------------------------------------------------------------
# a world of 8 gloo ranks, spawned

MESH8_K, MESH8_I = 36, 48          # 36 % 8 != 0: the padding is exercised
MESH8_RANKS = 8


def _isl_spec(pkg):
    return pkg.ConstellationSpec(
        num_satellites=MESH8_K,
        shells=(pkg.Shell(24, 4, 550_000.0, 53.0),
                pkg.Shell(12, 2, 560_000.0, 97.6)), seed=0)


def _mesh8_world(CN, FT, ISL):
    """One package's inputs of the 8-rank cases: (C, {case: (scheduler
    name, params, engine keywords)}), the reference's mesh test's world
    with sink relaying and gossip beside it."""
    K, I = MESH8_K, MESH8_I
    rng = np.random.default_rng(0)
    C = rng.random((I, K)) < 0.3
    grants = rng.integers(1, 4, C.shape).astype(np.int32) * C
    budget = CN.LinkBudget(visible=C, served=C,
                           assign=np.where(C, 0, -1).astype(np.int32),
                           grants=grants, need_up=2, need_dn=1)
    trace = FT.fault_trace(FT.FaultConfig(
        deorbit=FT.random_churn(K, I, 0.25, seed=1)), I, K=K)
    isl = ISL.ISL(topology=ISL.ring_topology(_isl_spec(CN)),
                  relay_windows=1, epoch=12)
    gossip = ISL.ISL(topology=ISL.ring_topology(_isl_spec(CN)),
                     relay_windows=2, epoch=12, cross_plane=True)
    fb = ("fedbuff", {"M": 6})
    return C, {"plain": fb + ({},),
               "budget": fb + ({"link_budget": budget},),
               "faults": fb + ({"faults": trace},),
               "sink": ("intra_plane", {"M": 6},
                        {"isl": isl, "faults": trace}),
               "gossip": ("isl_async", {}, {"isl": gossip,
                                            "link_budget": budget})}


def _mesh8_rank(rank, world, out_dir):
    """One rank of the spawned world: every case under the mesh (and, on
    rank 0, without it), pickled to ``rank{rank}.pkl``."""
    torch.set_num_threads(1)
    from repro_torch.core.search import score_candidates
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    mesh = TM.sim_mesh(device="cpu")
    assert TM.mesh_size(mesh) == world
    C, cases = _mesh8_world(TCN, TFT, TI)
    out = {}
    for case, (name, params, kw) in cases.items():
        for label, m, fast in (("none", None, True), ("mesh", mesh, True),
                               ("mesh_host", mesh, False)):
            if m is None and rank:
                continue
            eng = SimulationEngine(
                C, StubAdapter(C.shape[1]), make_scheduler(name, **params),
                EngineConfig(eval_every=MESH8_I + 1, fast_loop=fast),
                device="cpu", mesh=m, **kw)
            out[case, label] = _columns(eng, eng.run())
    rf = _forest()
    cand = np.random.default_rng(2).integers(0, 2, (16, 24)).astype(
        np.int32)
    state = TS.bootstrap_state(C.shape[1], device="cpu")
    for label, m in (("none", None), ("mesh", mesh))[int(rank > 0):]:
        out["scores", label] = score_candidates(
            cand, C[:24], state, 0, rf, 0.5, s_max=8, mesh=m)
        svc = ReplanService(rf, I0=24, num_candidates=64, n_min=3,
                            n_max=7, min_pool=8, mesh=m)
        out["replan", label] = (
            svc.replan(0, C[:24], state, 0, 0.5,
                       rng=np.random.default_rng(5)),
            svc.last_mode, svc.last_reason, svc.pool is None)
    out["collectives"] = dict(TM.collective_counts)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


_MESH8_SCRIPT = textwrap.dedent("""
    import sys
    import torch.multiprocessing as mp
    from tests.test_torch_mesh import _mesh8_rank

    if __name__ == "__main__":
        world = int(sys.argv[2])
        mp.spawn(_mesh8_rank, args=(world, sys.argv[1]), nprocs=world)
        print("MESH8_OK")
""")


def test_mesh_8_ranks_spawned(tmp_path):
    """8 gloo ranks in one spawned world (its own subprocess and
    timeout): at K 36, which 8 does not divide, the plain, budget and
    churn runs of the reference's mesh test, sink relaying and gossip,
    `score_candidates(mesh=)` with a forest over 16 candidates x 24
    windows, and one `ReplanService(mesh=)` answer. Every rank's results
    equal rank 0's, the mesh's equal `mesh=None`'s bit for bit, and the
    integers equal the reference's unsharded runs, which this process
    runs while the world runs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    deadline = time.monotonic() + 240
    with open(tmp_path / "out.txt", "w") as out, \
            open(tmp_path / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _MESH8_SCRIPT, str(tmp_path),
             str(MESH8_RANKS)], stdout=out, stderr=err, cwd=ROOT, env=env)
        try:
            ref = _reference()
            C, cases = _mesh8_world(TCN, TFT, TI)
            _, rcases = _mesh8_world(ref["CN"], ref["FT"], ref["ISL"])
            ref_runs = {}
            for case in cases:
                rname, rparams, rkw = rcases[case]
                reng = ref["SE"](C, ref["Stub"](MESH8_K),
                                 ref["make"](rname, **rparams),
                                 ref["EC"](eval_every=MESH8_I + 1), **rkw)
                ref_runs[case] = (reng, reng.run())
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, (tmp_path / "err.txt").read_text()[-3000:]
    assert "MESH8_OK" in (tmp_path / "out.txt").read_text()
    ranks = []
    for k in range(MESH8_RANKS):
        with open(tmp_path / f"rank{k}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    first = ranks[0]
    for other in ranks[1:]:
        assert other.keys() == {k for k in first if "none" not in k}
        for key in other:
            if key[0] == "scores":
                np.testing.assert_array_equal(other[key], first[key])
            elif key[0] == "replan":
                np.testing.assert_array_equal(other[key][0], first[key][0])
                assert other[key][1:] == first[key][1:]
            elif key != "collectives":
                _same(other[key], first[key])
    assert first["collectives"]["all_gather"] > 0
    for case in cases:
        _same(first[case, "mesh"], first[case, "none"])
        _same(first[case, "mesh_host"], first[case, "none"])
        reng, rres = ref_runs[case]
        _same_as_reference(first[case, "none"], reng, rres, case)
        assert rres.num_global_updates > 0, case
    np.testing.assert_array_equal(first["scores", "mesh"],
                                  first["scores", "none"])
    got, want = first["replan", "mesh"], first["replan", "none"]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == ("full", "mesh", True)
    assert want[1:] == ("full", "cold", False)
