"""Batched experiment sweeps: many protocol runs as one loop over the
windows; the port of `repro.fl.sweep`.

FedSpace's evaluation, and every study in `examples/`, is a grid of
variants over a shared world: scheduler knobs, fault scenarios, link
knobs, seeds. A sweep runs the whole protocol trajectory of every variant
of a group at once: the group's columns are stacked on a leading variant
axis on the run's device, and one Python loop over the W windows runs
the port's batched transitions once per window for the whole group —
fault reset, relay or gossip, `upload_step`, the scheduler's device
indicator, `aggregate_step(collect="hist")`, `download_step`,
`reset_relay`. The counters accumulate on the device and come to the host
once per group, after the loop; every column goes to the device before
it, so the loop itself never waits on the host. (The reference runs the
same body as one `jit(vmap(scan))` a group.)

A sweep tracks the *protocol* trajectory — versions, staleness
histograms, idleness, everything `SimResult` carries but accuracy: no
model is trained. Each variant's outcome equals its sequential
`SimulationEngine.run()`'s.

What is sweepable: an engine whose scheduler offers a `device_plan`
valid for the rest of the run (sync, async, fedbuff, periodic,
intra_plane, isl_async: the indicators the engine's fast loop scans
too), with the base protocol steps and no stop at a target accuracy.
FedSpace's plan holds only until its next re-plan, which depends on the
training status, so `sweep_engines` refuses it (run those variants
through `.run()`, where the engine's fast loop takes its plan chunk by
chunk, as `examples/fault_study_torch.py` does).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import staleness as SS
from repro_torch.core import transfers as TR
from repro_torch.fl.engine import SimResult, SimulationEngine
from repro_torch.tree import tree_flatten, tree_map


@dataclass
class SweepOutcome:
    """One variant's outcome: the protocol-level `SimResult` (accuracy
    empty — sweeps do not train models) plus host mirrors of the final
    per-satellite state, matching `SimulationEngine`'s properties."""
    result: SimResult
    version: np.ndarray
    pending: np.ndarray
    buffered: np.ndarray
    ig: int


def _not_sweepable(eng, why: str) -> ValueError:
    return ValueError(
        f"scheduler '{eng.scheduler.name}' is not sweepable: {why} — "
        "run this variant sequentially via SimulationEngine.run()")


def _variant_columns(eng: SimulationEngine):
    """Resolve one engine into (group key, per-variant host columns),
    mirroring what its `run()` would execute, or raise for an inherently
    sequential variant."""
    if any(getattr(type(eng), m) is not getattr(SimulationEngine, m)
           for m in ("on_uploads", "on_decide", "on_aggregate",
                     "on_downloads")):
        raise _not_sweepable(eng, "subclassed protocol steps")
    cfg = eng.config
    if cfg.target_acc is not None and cfg.stop_at_target:
        raise _not_sweepable(
            eng, "stop-at-target runs end at a training-dependent window")
    W, K = eng.num_windows, eng.K
    sched = eng.scheduler
    mode = getattr(sched, "isl_mode", None)
    isl_rt = eng.isl if (eng.isl is not None and mode is not None) \
        else None
    mode = mode if isl_rt is not None else None
    sched.isl = isl_rt
    sched.mesh = None
    sched.reset()
    if sched.replans:
        raise _not_sweepable(
            eng, "its device plan replans mid-run (finite horizon)")

    linked = eng.link_budget is not None
    state0 = SS.bootstrap_state(K, progress=linked, relay=mode == "sink",
                                device=eng.device)
    need_up = need_dn = None
    if linked:
        need_up = int(eng.link_budget.need_up)
        need_dn = int(eng.link_budget.need_dn)
    plan_link = None if not linked else SS.LinkGate(
        eng._plan_grants, need_up, need_dn)
    plan = sched.device_plan(0, K=K, state=state0, ig=0,
                             connectivity=eng._plan_C, status=0.0,
                             link=plan_link)
    if plan is None:
        raise _not_sweepable(eng, "no device plan")
    fn, args, _ = plan     # horizon None: the plan holds to the end

    cols = {"C": np.asarray(eng.C[:W], bool), "args": args}
    if linked:
        cols["grant"] = np.asarray(eng._grants[:W], np.int32)
        cols["need_up"] = np.int32(need_up)
        cols["need_dn"] = np.int32(need_dn)
    if eng._trace is not None:
        cols["revive"] = np.asarray(eng._trace.revive[:W], bool)
        cols["alive"] = np.asarray(eng._trace.alive[:W], bool)
    if mode == "sink":
        # the per-epoch elections expanded into per-window rows, on the
        # host before the loop
        ep = isl_rt.epoch
        sink = np.empty((W, K), np.int64)
        need = np.empty((W, K), np.int32)
        alive_rows = cols.get("alive")
        for e0 in range(0, W, ep):
            e1 = min(e0 + ep, W)
            alive_e = None if alive_rows is None \
                else alive_rows[e0:e1].any(axis=0)
            s, n = isl_rt.sink_plan(eng.C[e0:e1], alive=alive_e)
            sink[e0:e1] = s
            need[e0:e1] = n
        cols["sink"], cols["need_hops"] = sink, need
    elif mode == "gossip":
        topo = isl_rt.topology
        idx = np.arange(K)
        cross = isl_rt.cross_plane
        for name, arr in (("nxt", topo.nxt), ("prv", topo.prv),
                          ("left", topo.left if cross else idx),
                          ("right", topo.right if cross else idx)):
            cols[name] = np.asarray(arr, np.int64)
        cols["period"] = np.int32(max(isl_rt.relay_windows, 1))

    leaves, structure = tree_flatten(args)
    args_sig = (repr(structure),
                tuple((tuple(x.shape), str(x.dtype)) for x in leaves))
    key = (fn, mode, W, K, cfg.s_max, linked, eng._trace is not None,
           args_sig)
    return key, cols


# per-window columns: stacked to (W, V, K) so that a window's rows are one
# contiguous (V, K) slice
_WINDOWED = ("C", "grant", "revive", "alive", "sink", "need_hops")


def _to_device(members, device):
    """Stack the group's host columns on a leading variant axis and put
    them on `device` (before the window loop: a copy from pageable host
    memory inside it would wait on the host)."""
    out = {}
    for name in members[0]:
        if name == "args":
            out[name] = tree_map(lambda *xs: torch.stack(xs).to(device),
                                 *[m[name] for m in members])
            continue
        stacked = np.stack([m[name] for m in members])
        if name in _WINDOWED:
            stacked = np.ascontiguousarray(np.swapaxes(stacked, 0, 1))
        elif stacked.ndim == 1:   # per-variant scalars, (V, 1) columns
            stacked = stacked[:, None]   # that broadcast against (V, K)
        out[name] = torch.as_tensor(stacked, device=device)
    return out


def _window_loop(cols, *, indicator, isl_mode, s_max):
    """The group's full trajectories, one pass over the windows with every
    variant on the leading axis. `cols` are the device columns of
    `_to_device`. Returns the device tensors of the final state, the
    global versions and the counters; nothing here reads the device."""
    W, V, K = cols["C"].shape
    device = cols["C"].device
    linked = "grant" in cols
    state = SS.bootstrap_state(K, progress=linked, relay=isl_mode == "sink",
                               device=device)
    state = SS.SatState(*(None if x is None else x.expand(V, K).clone()
                          for x in state))
    args = cols["args"]
    ig = torch.zeros(V, dtype=torch.int32, device=device)
    total = torch.zeros(V, dtype=torch.int32, device=device)
    idle, nagg = torch.zeros_like(total), torch.zeros_like(total)
    hist = torch.zeros((V, s_max + 1), dtype=torch.int32, device=device)
    for t in range(W):
        conn = cols["C"][t]
        gate = None if not linked else SS.LinkGate(
            cols["grant"][t], cols["need_up"], cols["need_dn"])
        kw = {name: cols[name][t] for name in ("alive", "sink", "need_hops")
              if name in cols}
        gossip = None
        if isl_mode == "gossip":
            period = cols["period"][:, 0]
            gossip = (cols["nxt"], cols["prv"], cols["left"], cols["right"],
                      (period <= 1) | (t % period == 0))
        up_st, info = TR.window_upload(
            state, ig, conn, gate, gossip=gossip, **kw,
            revive=cols["revive"][t] if "revive" in cols else None)
        n_buf = info["n_buffered"]
        a = indicator(t, n_buf, args) & (n_buf > 0)
        # the engine trains and aggregates here; the sweep runs the same
        # transition, whose histogram is the engine's bookkeeping
        ag_st, new_ig, agg = SS.aggregate_step(up_st, ig, a, s_max=s_max,
                                               collect="hist")
        state = TR.window_download(ag_st, new_ig, conn, gate, **kw)
        ig = new_ig
        total = total + info["n_connected"]
        idle = idle + info["n_idle"]
        hist = hist + agg["hist"]
        nagg = nagg + agg["n_aggregated"]
    return {"version": state.version, "pending": state.pending,
            "buffered": state.buffered, "ig": ig, "total": total,
            "idle": idle, "hist": hist, "nagg": nagg}


def _run_group(members, *, indicator, isl_mode, s_max, device):
    """One group: its columns to the device, the window loop, and the
    results to the host once."""
    cols = _to_device(members, device)
    out = _window_loop(cols, indicator=indicator, isl_mode=isl_mode,
                       s_max=s_max)
    return {k: v.cpu().numpy() for k, v in out.items()}


def sweep_engines(engines: Sequence[SimulationEngine]
                  ) -> List[SweepOutcome]:
    """Run every engine's full protocol trajectory, a group of variants at
    a time.

    Engines are grouped by their static shape — scheduler indicator, ISL
    mode, horizon, K, s_max, and which optional columns (link grants,
    fault masks) they carry — and each group runs as one window loop on
    the engines' device. Outcomes come back in input order, each equal to
    that engine's own `run()` (protocol counters and final state;
    `accuracy` is empty — sweeps do not train).

    Raises ValueError for inherently sequential variants (FedSpace's
    re-planning, subclassed steps, stop-at-target runs) and when the
    engines do not all live on one device.
    """
    devices = {e.device for e in engines}
    if len(devices) > 1:
        raise ValueError(
            f"sweep_engines: the engines live on {len(devices)} devices "
            f"({', '.join(sorted(str(d) for d in devices))}); a sweep runs "
            f"on one")
    keyed = [_variant_columns(e) for e in engines]
    groups = {}
    for i, (key, cols) in enumerate(keyed):
        groups.setdefault(key, []).append((i, cols))

    outcomes: List[SweepOutcome] = [None] * len(engines)
    for (fn, mode, W, K, s_max, *_rest), members in groups.items():
        out = _run_group([cols for _, cols in members], indicator=fn,
                         isl_mode=mode, s_max=s_max,
                         device=engines[members[0][0]].device)
        for v, (i, _) in enumerate(members):
            eng = engines[i]
            res = SimResult(scheme=eng.scheduler.name,
                            target_acc=eng.config.target_acc)
            res.staleness_hist = out["hist"][v].astype(np.int64)
            res.idle_connections = int(out["idle"][v])
            res.total_connections = int(out["total"][v])
            res.num_global_updates = int(out["ig"][v])
            res.num_aggregated_gradients = int(out["nagg"][v])
            res.windows_run = W
            outcomes[i] = SweepOutcome(
                result=res, version=out["version"][v],
                pending=out["pending"][v], buffered=out["buffered"][v],
                ig=int(out["ig"][v]))
    return outcomes


def run_sweep(worlds: Sequence) -> List[SimResult]:
    """Batched counterpart of ``[w.run() for w in worlds]`` over
    `Federation` variants (`with_scheduler`/`with_faults` clones or any
    mix): builds each world's engine on the world's device, runs them
    through `sweep_engines`, and returns the per-variant `SimResult`s in
    input order."""
    return [o.result for o in
            sweep_engines([w.engine(device=w.device) for w in worlds])]
