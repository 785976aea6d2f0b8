"""The port's `run_simulation` wrapper, the checkpoint, early-stop and
progress callbacks, and the npz save/load of `repro_torch.ckpt`, against
the JAX package's on one tiny world from the reference's initial model:
integer counters equal, accuracies within 1/NUM_VAL and val losses and
models within 1e-4 (tests/test_torch_engine.py's tolerances); early stop
at the same window; the same checkpoint file names and keys, each
package's npz loading into the other's tree; the reference's progress
line."""
import contextlib
import io
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.api as RA
import repro_torch.fl.api as TA
from repro.ckpt import checkpoint as RCK
from repro.core.scheduler import make_scheduler as rmake
from repro.fl import callbacks as RCB
from repro.fl.engine import EngineConfig as REC
from repro.fl.simulation import run_simulation as rrun
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.core.scheduler import make_scheduler as tmake
from repro_torch.fl import callbacks as TCB
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.fl.simulation import run_simulation as trun
from repro_torch.weights import params_from_numpy, params_to_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

NUM_VAL = 200
KW = dict(local_steps=2, client_lr=1.0, eval_every=8, seed=0,
          stop_at_target=False)


def _exp(api, ec):
    return api.FLExperiment(
        name="small",
        constellation=api.ConstellationConfig(num_satellites=16, days=0.5),
        dataset=api.DatasetConfig(num_train=800, num_val=NUM_VAL, noise=2.2),
        partition=api.PartitionConfig(kind="noniid"),
        adapter=api.AdapterConfig(kind="mlp", params={"hidden": 24}),
        train=ec(local_steps=2))


@pytest.fixture(scope="module")
def worlds():
    rfed = RA.Federation.from_experiment(_exp(RA, REC))
    tfed = TA.Federation.from_experiment(_exp(TA, TEC), device="cpu")
    p0 = jax.tree.map(np.asarray, rfed.adapter.init(jax.random.PRNGKey(0)))
    return rfed, tfed, p0


def _same_results(rres, tres):
    for f in ("num_global_updates", "num_aggregated_gradients",
              "idle_connections", "total_connections", "windows_run",
              "eval_windows", "time_to_target_days", "scheme"):
        assert getattr(tres, f) == getattr(rres, f), f
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    np.testing.assert_allclose(tres.val_loss, rres.val_loss, atol=1e-4)


@pytest.mark.parametrize("sched,kw", [
    (("fedbuff", {"M": 4}), {}),
    (("async", {}), dict(repeat_connectivity=2, max_windows=70)),
    (("periodic", {"period": 5}), dict(target_acc=0.05, s_max=4)),
])
def test_run_simulation_equals_reference(worlds, sched, kw):
    rfed, tfed, p0 = worlds
    name, params = sched
    rres = rrun(rfed.C, rfed.adapter, rmake(name, **params),
                init_params=p0, **KW, **kw)
    tres = trun(tfed.C, tfed.adapter, tmake(name, **params),
                init_params=params_from_numpy(p0, "cpu"), device="cpu",
                **KW, **kw)
    _same_results(rres, tres)
    assert tres.num_global_updates >= 3
    if "repeat_connectivity" in kw:
        assert tres.windows_run == 70 > tfed.C.shape[0]


def test_run_simulation_without_a_card_raises_and_topk_names_its_slice(
        worlds):
    """Without a card the default device raises; `uplink_topk` (which
    raised until the compression slice) runs compressed, with the
    reference's counters."""
    rfed, tfed, p0 = worlds
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trun(tfed.C, tfed.adapter, tmake("async"))
    rres = rrun(rfed.C, rfed.adapter, rmake("fedbuff", M=4),
                init_params=p0, uplink_topk=0.25, **KW)
    tres = trun(tfed.C, tfed.adapter, tmake("fedbuff", M=4),
                init_params=params_from_numpy(p0, "cpu"), device="cpu",
                uplink_topk=0.25, **KW)
    _same_results(rres, tres)
    assert tres.num_global_updates >= 3


def _lines(text):
    """The progress lines with their trailing wall seconds taken off."""
    return [re.sub(r"\s+\(\d+s\)$", "", x) for x in text.splitlines()]


@pytest.fixture(scope="module")
def callback_runs(worlds, tmp_path_factory):
    """One FedBuff run on each package from the reference's initial model,
    with the three callbacks attached: early stop (patience 2, min delta
    0.01), checkpoints every 3 global updates, and the progress lines."""
    rfed, tfed, p0 = worlds
    root = tmp_path_factory.mktemp("checkpoints")
    out = {}
    for side, fed, cb, kw in (
            ("ref", rfed, RCB, dict(init_params=p0)),
            ("port", tfed, TCB, dict(init_params=params_from_numpy(p0, "cpu"),
                                     device="cpu"))):
        stop = cb.EarlyStopCallback(patience=2, min_delta=0.01)
        eng = fed.with_scheduler("fedbuff", M=4).engine(
            callbacks=[stop, cb.CheckpointCallback(str(root / side), 3),
                       cb.ProgressCallback("ref ")], **kw)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = eng.run()
        out[side] = SimpleNamespace(engine=eng, result=res, stop=stop,
                                    dir=root / side,
                                    lines=_lines(printed.getvalue()))
    return out


def test_early_stop_at_the_same_window(worlds, callback_runs):
    ref, port = callback_runs["ref"], callback_runs["port"]
    _same_results(ref.result, port.result)
    assert port.result.windows_run < worlds[1].C.shape[0]  # it stopped early
    assert port.stop.stale_evals == ref.stop.stale_evals == 2
    assert port.stop.best == pytest.approx(ref.stop.best,
                                           abs=1.0 / NUM_VAL + 1e-6)


def test_checkpoints_have_the_same_names_and_keys_and_load_across(
        callback_runs):
    ref, port = callback_runs["ref"], callback_runs["port"]
    rdir, tdir = ref.dir, port.dir
    reng, teng = ref.engine, port.engine
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(rdir))
    n = port.result.num_global_updates
    assert n >= 6
    assert f"model_v{n:06d}.npz" in names
    assert len(names) == len(set(range(3, n + 1, 3)) | {n})
    for name in names:
        rz, tz = np.load(rdir / name), np.load(tdir / name)
        assert sorted(tz.files) == sorted(rz.files)
        for k in rz.files:
            assert tz[k].dtype == rz[k].dtype and tz[k].shape == rz[k].shape
            np.testing.assert_allclose(tz[k], rz[k], atol=1e-4, err_msg=k)
    last = names[-1]
    into_port = TCK.load_pytree(str(rdir / last), teng.params)
    into_ref = RCK.load_pytree(str(tdir / last), reng.params)
    for k, leaf in into_port.items():
        assert isinstance(leaf, torch.Tensor)
        assert leaf.dtype == teng.params[k].dtype
        np.testing.assert_allclose(leaf.numpy(), np.asarray(reng.params[k]),
                                   atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(np.asarray(into_ref[k]),
                                      teng.params[k].numpy())


def test_npz_keys_of_nested_trees_match_the_reference(tmp_path):
    """Dicts in sorted key order and lists by index, joined by "/" — the
    DenseNet adapter's tree shape — round-trip in both directions."""
    r = np.random.default_rng(0)
    tree = {"stem": r.random((3, 2)).astype(np.float32),
            "blocks": [{"w": r.random(4).astype(np.float32),
                        "b": np.arange(3, dtype=np.int32)},
                       [r.random(2).astype(np.float32)]],
            "head": {"a": {"z": r.random((2, 2)).astype(np.float32)}}}
    ref_path, port_path = tmp_path / "ref.npz", tmp_path / "sub" / "port.npz"
    RCK.save_pytree(str(ref_path), jax.tree.map(jnp.asarray, tree))
    ttree = params_from_numpy(tree, "cpu")
    TCK.save_pytree(str(port_path), ttree)
    assert sorted(np.load(port_path).files) == sorted(np.load(ref_path).files)
    assert "blocks/0/w" in np.load(port_path).files
    back = TCK.load_pytree(str(ref_path), ttree)
    ref_back = RCK.load_pytree(str(port_path), tree)
    for a, b, c in zip(jax.tree.leaves(params_to_numpy(back)),
                       jax.tree.leaves(tree), jax.tree.leaves(ref_back)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
        assert a.dtype == b.dtype == c.dtype


def test_progress_prints_the_reference_line(callback_runs):
    ref, port = callback_runs["ref"], callback_runs["port"]
    got = port.lines
    assert len(got) == len(ref.lines) == len(port.result.eval_windows) >= 3
    assert got[0].startswith("ref [fedbuff] day  0.07  acc=")
    for a, b in zip(got, ref.lines):
        pa, pb = re.split(r"acc=\S+\s+val_loss=\S+", a), \
            re.split(r"acc=\S+\s+val_loss=\S+", b)
        assert pa == pb                  # the day, the update count
        va = [float(x) for x in re.findall(r"=(\d+\.\d+)", a)]
        vb = [float(x) for x in re.findall(r"=(\d+\.\d+)", b)]
        np.testing.assert_allclose(va, vb, atol=1.0 / NUM_VAL + 1e-3)
