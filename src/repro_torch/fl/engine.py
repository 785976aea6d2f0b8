"""Event-driven FL simulation engine over the connectivity sequence
(Algorithm 1), decomposed into overridable protocol steps.

Time advances in T0 windows (15 min each). At window i the GS:
  receives pending updates from connected satellites (`on_uploads`), asks
  the scheduler whether to aggregate a^i (`on_decide`), applies the
  staleness-compensated update of eq. 4 when a^i = 1 (`on_aggregate`), and
  broadcasts the current model (`on_downloads`).

The port of `repro.fl.engine` runs the reference's per-window host loop
(`SimulationEngine._run_window`) with the protocol state (`SatState`),
the model, the checkpoints and the client data on the run's device. One
small device-to-host read per window brings back the upload counters the
scheduler decides on. The reference's chunked fast loop (jitted scans
between aggregation events) is a JAX `scan` idiom; its PyTorch
counterpart (a CUDA graph) is ROADMAP A.8, and the reference asserts that
both of its loops give the same bits, so the host loop is the contract.

Finite link budgets (`repro_torch.core.connectivity.LinkBudget`, built
by `Federation` from a constrained `LinkConfig`) run through the same
transitions: the engine then runs on the capacity-resolved (served)
connectivity and gates every upload and download on the accumulated
grants (`LinkGate`). Inter-satellite links (`repro_torch.core.isl.ISL`)
compose in front of them when the scheduler declares an `isl_mode`: sink
relaying ("sink") or neighbour gossip ("gossip"). The grants, sink plans
and neighbour arrays are put on the device once per run (sink plans once
per election epoch).

Fault injection (`repro_torch.core.faults`, `faults=` a `FaultTrace`)
splits the world in two views (`resolve_run_artifacts`): the run executes
on the fault-masked connectivity and grants, while the scheduler plans on
the clean ones unless the trace is an oracle's. Reviving satellites
re-enter through `fault_reset` before each window's upload, and the alive
mask keeps dead satellites out of the sink relay and gossip. The masks go
to the device once per run. The satellite-axis mesh raises
NotImplementedError naming its slice (ROADMAP A.10).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointStore
from repro_torch.core import faults as FT
from repro_torch.core import staleness as SS
from repro_torch.core import transfers as TR
from repro_torch.core.aggregation import aggregation_weights
from repro_torch.core.scheduler import Scheduler
from repro_torch.device import resolve_device
from repro_torch.fl.client import make_batched_client_update
from repro_torch.kernels.agg.ops import FlatLayout, aggregate_flat
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

T0_MINUTES = 15.0


@dataclass
class SimResult:
    """Outcome of one simulated federated run.

    Fields: `scheme` (scheduler name), `accuracy`/`val_loss`/
    `eval_windows` (one entry per eval checkpoint), `staleness_hist`
    (aggregated-gradient counts per clipped staleness),
    `idle_connections`/`total_connections` (eq.-10 idleness accounting),
    `num_global_updates` (aggregations), `num_aggregated_gradients`,
    `windows_run`, and `time_to_target_days`/`target_acc` when a target
    accuracy was set. `replan_stats` holds the full/delta/invalidated
    counts of the scheduler's replan service, None without one.
    `days(window)` converts a window index to
    simulated days; `summary()` returns the JSON-friendly digest."""
    scheme: str
    accuracy: List[float] = field(default_factory=list)
    val_loss: List[float] = field(default_factory=list)
    eval_windows: List[int] = field(default_factory=list)
    staleness_hist: Optional[np.ndarray] = None
    idle_connections: int = 0
    total_connections: int = 0
    num_global_updates: int = 0
    num_aggregated_gradients: int = 0
    windows_run: int = 0
    time_to_target_days: Optional[float] = None
    target_acc: Optional[float] = None
    replan_stats: Optional[dict] = None

    def days(self, window: int) -> float:
        """Simulated days elapsed at `window` (T0 = 15-minute windows)."""
        return window * T0_MINUTES / 60.0 / 24.0

    def summary(self) -> dict:
        """JSON-friendly digest (final/best accuracy, counters, hist)."""
        return {
            "scheme": self.scheme,
            "final_acc": self.accuracy[-1] if self.accuracy else None,
            "best_acc": max(self.accuracy) if self.accuracy else None,
            "time_to_target_days": self.time_to_target_days,
            "global_updates": self.num_global_updates,
            "aggregated_gradients": self.num_aggregated_gradients,
            "idle_connections": self.idle_connections,
            "total_connections": self.total_connections,
            "staleness_hist": (self.staleness_hist.tolist()
                               if self.staleness_hist is not None else None),
            "replan_stats": self.replan_stats,
        }


@dataclass
class EngineConfig:
    """Protocol/training knobs of one simulated run (field for field the
    reference's `repro.fl.engine.EngineConfig`)."""
    local_steps: int = 4
    batch_size: int = 32
    client_lr: float = 0.05
    server_lr: float = 1.0
    alpha: float = 0.5
    eval_every: int = 8
    target_acc: Optional[float] = None
    max_windows: Optional[int] = None
    repeat_connectivity: int = 1   # 0: auto-tile C to cover max_windows
    s_max: int = 8
    # None = unset: lets experiment-level settings (FLExperiment.seed,
    # LinkConfig.uplink_topk) apply without 0 doubling as a sentinel
    seed: Optional[int] = None           # unset -> 0
    stop_at_target: bool = True
    uplink_topk: Optional[float] = None  # >0: compressed uplink; unset -> 0
    # dense int8 uplink quantization; unset -> False / LinkConfig fallback
    uplink_int8: Optional[bool] = None
    # the reference's switch between its chunked fast loop and the
    # per-window host loop; the port has only the host loop so far, which
    # runs either way
    fast_loop: bool = True

    def __post_init__(self):
        # 0.0 stays legal alongside None: the engine resolves the unset
        # sentinel to 0.0 via dataclasses.replace, which re-runs this hook
        v = self.uplink_topk
        if v is not None and v != 0.0 and not 0.0 < v <= 1.0:
            raise ValueError(
                f"EngineConfig.uplink_topk must be in (0, 1], got {v}")


class RunArtifacts(NamedTuple):
    """The resolved world arrays one run executes on: the effective
    connectivity/grants (`C`/`grants`), the scheduler-facing planning view
    (`plan_C`/`plan_grants` — the same objects unless a blind fault trace
    splits them), and the horizon-extended `FaultTrace`."""
    C: np.ndarray
    grants: Optional[np.ndarray]
    plan_C: np.ndarray
    plan_grants: Optional[np.ndarray]
    trace: Optional[FT.FaultTrace]


def resolve_run_artifacts(C, cfg: EngineConfig, *, link_budget=None,
                          faults=None) -> RunArtifacts:
    """Resolve raw world inputs into `RunArtifacts`: substitute the link
    budget's capacity-resolved `served` matrix, tile the connectivity (and
    grants) to the requested horizon per `cfg.repeat_connectivity` (0 =
    auto: cover `max_windows`), extend the fault trace over the tiled
    length, and split the plan view from the executed view (clean against
    masked under a blind trace, the same objects under none or an oracle).
    The sweep (`repro_torch.fl.sweep`) reads an engine's resolution."""
    grants = assign = None
    if link_budget is not None:
        C = link_budget.served
        grants = np.asarray(link_budget.grants, np.int32)
        assign = np.asarray(link_budget.assign, np.int32)
    repeat = cfg.repeat_connectivity
    if repeat == 0:
        need = cfg.max_windows or C.shape[0]
        repeat = max(1, -(-int(need) // C.shape[0]))
    if repeat > 1:
        C = np.concatenate([C] * repeat, axis=0)
        if grants is not None:
            grants = np.concatenate([grants] * repeat, axis=0)
            assign = np.concatenate([assign] * repeat, axis=0)
    C = np.asarray(C, bool)
    plan_C, plan_grants = C, grants
    trace = None if faults is None else faults.extended(C.shape[0])
    if trace is None:
        exec_C, exec_grants = C, grants
    elif link_budget is not None:
        exec_C, exec_grants = FT.mask_served(C, grants, assign, trace)
    else:
        exec_C = C & trace.mask[:C.shape[0]]
        exec_grants = None
    if trace is not None and trace.oracle:
        plan_C, plan_grants = exec_C, exec_grants
    return RunArtifacts(exec_C, exec_grants, plan_C, plan_grants, trace)


class SimulationEngine:
    """One federated run: connectivity x adapter x scheduler -> SimResult.

    Protocol steps (`on_uploads`, `on_decide`, `on_aggregate`,
    `on_downloads`) are methods so scenario variants override exactly the
    step they change; callbacks observe the run without touching it.

    Args:
      C: (num_windows, K) bool connectivity matrix (tiled per
        `EngineConfig.repeat_connectivity`).
      adapter: model adapter (init/loss/client_batch/accuracy/val_loss),
        built on `device`.
      scheduler: aggregation policy (`repro_torch.core.scheduler`).
      config: `EngineConfig`; keyword `overrides` replace single fields.
      callbacks: `repro_torch.fl.callbacks` observers.
      init_params: optional initial global model, a dict of tensors or
        arrays (default: `adapter.init` from a generator seeded with
        `config.seed`).
      device: where the run lives. None means "cuda", and raises when no
        CUDA device is present; pass "cpu" to run on the CPU.
      link_budget: optional `repro_torch.core.connectivity.LinkBudget`.
        The engine then runs on its `served` matrix (replacing `C`; the
        schedulers plan on it too), the satellites carry the `progress`
        column, and every upload and download is gated on the accumulated
        grants. A trivial budget (unlimited capacity, zero needs) gives
        the bits of `link_budget=None`.
      isl: optional `repro_torch.core.isl.ISL` runtime. It takes effect
        only when the scheduler declares an `isl_mode` ("sink" or
        "gossip"); ground-only schedulers run the unmodified protocol, so
        with/without-ISL comparisons share one world.
      faults: optional `repro_torch.core.faults.FaultTrace` (resolved by
        `Federation` from `FLExperiment.faults`). The run then executes on
        the fault-masked artifacts — dead satellites lose every contact
        and their part in the sink relay and gossip, grants are
        weather-rescaled, reviving satellites re-enter through
        `fault_reset`'s forced re-download — while the scheduler plans on
        the clean connectivity and grants unless the trace is an
        oracle's. `faults=None` keeps every run as it is without faults.
      mesh: anything but None raises NotImplementedError (the mesh slice,
        ROADMAP A.10).
    """

    def __init__(self, C: np.ndarray, adapter, scheduler: Scheduler,
                 config: Optional[EngineConfig] = None, *,
                 callbacks: Sequence = (), init_params=None, device=None,
                 link_budget=None, isl=None, faults=None, mesh=None,
                 **overrides):
        if mesh is not None:
            raise NotImplementedError(
                "SimulationEngine(mesh=...) is not ported yet: it comes "
                "with the mesh slice of the port (ROADMAP A.10)")
        self.device = resolve_device(device)
        if adapter.device != self.device:
            raise ValueError(f"adapter lives on {adapter.device}, the run "
                             f"on {self.device}")
        cfg = config if config is not None else EngineConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        cfg = dataclasses.replace(
            cfg, seed=0 if cfg.seed is None else cfg.seed,
            uplink_topk=(0.0 if cfg.uplink_topk is None
                         else cfg.uplink_topk),
            uplink_int8=bool(cfg.uplink_int8))
        self.config = cfg
        self.link_budget = link_budget
        self.isl = isl
        self.faults = faults
        art = resolve_run_artifacts(C, cfg, link_budget=link_budget,
                                    faults=faults)
        self.C, self._grants = art.C, art.grants
        self._plan_C, self._plan_grants = art.plan_C, art.plan_grants
        self._trace = art.trace
        self.adapter = adapter
        self.scheduler = scheduler
        self.callbacks = list(callbacks)
        self._init_params = init_params
        self._stop_requested = False

        self.num_windows = self.C.shape[0]
        if cfg.max_windows:
            self.num_windows = min(self.num_windows, cfg.max_windows)
        self.K = self.C.shape[1]

    # ------------------------------------------------------------------ API

    def request_stop(self) -> None:
        """Ask the engine to stop after the current window (callbacks use
        this for early stopping)."""
        self._stop_requested = True

    @property
    def version(self) -> np.ndarray:
        """Host mirror of the last global version each satellite received.
        Read-only diagnostic — the authoritative state is `self.state`."""
        return self.state.version.cpu().numpy()

    @property
    def pending(self) -> np.ndarray:
        """Host mirror of each satellite's pending-update base version."""
        return self.state.pending.cpu().numpy()

    @property
    def buffered_base(self) -> np.ndarray:
        """Host mirror of the GS buffer's per-satellite base versions."""
        return self.state.buffered.cpu().numpy()

    @property
    def transfer_progress(self) -> Optional[np.ndarray]:
        """Host mirror of each satellite's in-progress transfer units (None
        unless the run models a link budget)."""
        p = self.state.progress
        return None if p is None else p.cpu().numpy()

    @property
    def relay_units(self) -> Optional[np.ndarray]:
        """Host mirror of each satellite's accumulated ISL hop units (None
        unless the run relays through sink satellites)."""
        r = self.state.relay
        return None if r is None else r.cpu().numpy()

    def prepare(self) -> None:
        """Initialize run state (model, client-update functions, checkpoint
        store, protocol state on the device). `run` calls this; tests call
        it directly to drive individual protocol steps."""
        cfg = self.config
        # ISL runs only when both the runtime and a scheduler-declared mode
        # are present; the scheduler reads the runtime (its topology)
        # through its `isl` attribute, bound before reset()
        mode = getattr(self.scheduler, "isl_mode", None)
        self._isl = self.isl if mode is not None else None
        self._isl_mode = mode if self._isl is not None else None
        self.scheduler.isl = self._isl
        self.scheduler.reset()
        self._stop_requested = False
        if self._init_params is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            params = self.adapter.init(gen)
        else:
            params = tree_map(
                lambda a: torch.as_tensor(a, device=self.device),
                self._init_params)
        # the global model lives in one flat buffer (`FlatLayout`: leaves
        # in tree order, each on 16 bytes); `self.params` is a tree of
        # views of it, re-viewed onto each aggregation's output
        leaves, self._structure = tree_flatten(params)
        self.layout = FlatLayout.of(leaves)
        self.params = self._view(self.layout.flat(leaves))
        self._updates = None      # the update buffer, made at first use
        mask = self.adapter.trainable_mask(params) \
            if hasattr(self.adapter, "trainable_mask") else None
        self._batched_update = make_batched_client_update(
            self.adapter, local_steps=cfg.local_steps, lr=cfg.client_lr,
            trainable_mask=mask, uplink_topk=cfg.uplink_topk,
            uplink_int8=bool(cfg.uplink_int8))

        self.store = CheckpointStore(keep_in_memory=cfg.s_max + 26)
        self.store.put(0, self.params)
        self.ig = 0
        # every satellite holds w^0 with a pending round on it (Alg. 1
        # init); link-budget runs carry the in-progress-transfer column,
        # sink-relay runs the relay column
        linked = self.link_budget is not None
        self.state = SS.bootstrap_state(self.K, progress=linked,
                                        relay=self._isl_mode == "sink",
                                        device=self.device)
        # the run's link gates: the executed grants on the device (one
        # copy per run) for the transitions, and host gates for the
        # schedulers — the executed one, and the plan view they decide on
        # (a blind fault run's clean grants)
        self._link = self._plan_link = self._grants_dev = None
        if linked:
            b = self.link_budget
            self._link = SS.LinkGate(self._grants, int(b.need_up),
                                     int(b.need_dn))
            self._plan_link = self._link \
                if self._plan_grants is self._grants \
                else SS.LinkGate(self._plan_grants, int(b.need_up),
                                 int(b.need_dn))
            self._grants_dev = torch.as_tensor(
                self._grants[:self.num_windows], device=self.device)
        # fault masks on the device, one copy per run (None without a
        # trace); `_alive` stays on the host for the sink elections
        self._alive = self._alive_dev = self._revive_dev = None
        if self._trace is not None:
            self._alive = np.asarray(self._trace.alive[:self.num_windows],
                                     bool)
            self._alive_dev = torch.as_tensor(self._alive,
                                              device=self.device)
            self._revive_dev = torch.as_tensor(
                np.asarray(self._trace.revive[:self.num_windows], bool),
                device=self.device)
        # ISL device arrays: sink plans per election epoch (made at the
        # epoch's first window), the gossip neighbours once per run
        self._sink_cache = {}
        self._gossip_dev = None
        if self._isl_mode == "gossip":
            topo = self._isl.topology
            idx = np.arange(self.K)
            cross = self._isl.cross_plane
            self._gossip_dev = tuple(
                torch.as_tensor(np.asarray(a, np.int64), device=self.device)
                for a in (topo.nxt, topo.prv,
                          topo.left if cross else idx,
                          topo.right if cross else idx))
        self.result = SimResult(scheme=self.scheduler.name,
                                target_acc=cfg.target_acc)
        self.result.staleness_hist = np.zeros(cfg.s_max + 1, np.int64)
        self.status = float(self.adapter.val_loss(self.params))

    def run(self) -> SimResult:
        """Execute the run: `prepare()`, then advance windows until the
        horizon, a stop request, or the target accuracy. Returns the
        populated `SimResult`."""
        self.prepare()
        try:
            self._emit("on_run_begin")
            i = 0
            while i < self.num_windows:
                i, stop = self._run_window(i)
                if stop or self._stop_requested:
                    break
        finally:
            service = getattr(self.scheduler, "service", None)
            if service is not None:
                self.result.replan_stats = {
                    "full": service.stats["full"],
                    "delta": service.stats["delta"],
                    "invalidated": dict(service.stats["invalidated"]),
                }
            # always emitted (even on a mid-run exception) so callbacks
            # holding resources — open files, sockets — can release them
            self._emit("on_run_end", self.result)
        return self.result

    # ---------------------------------------------------- host window loop

    def _run_window(self, i: int):
        """One window through the overridable protocol-step methods.
        Returns (next window, stop)."""
        cfg = self.config
        conn = self.C[i]
        n_buf = self.on_uploads(i, conn)
        a = self.on_decide(i, n_buf)
        if a and n_buf > 0:
            self.on_aggregate(i)
        self.on_downloads(i, conn)
        self.result.windows_run = i + 1
        stop = False
        if (i + 1) % cfg.eval_every == 0 or i == self.num_windows - 1:
            stop = self.evaluate(i)
        self._emit("on_window_end", i)
        return i + 1, stop

    # -------------------------------------------------------- protocol steps

    def _gate(self, i: int):
        """The device `LinkGate` of window i (None without a link
        budget): a row of the run's grants on the device."""
        if self._link is None:
            return None
        return SS.LinkGate(self._grants_dev[i], self._link.need_up,
                           self._link.need_dn)

    def _sink_plan(self, i: int):
        """Device (sink (K,) int64, need_hops (K,) int32) of window i's
        election epoch, elected once per epoch from the run's effective
        connectivity (among the satellites alive at some window of the
        epoch, in a fault run)."""
        ep = self._isl.epoch
        e = i // ep
        if e not in self._sink_cache:
            alive_e = None if self._alive is None else \
                self._alive[e * ep:(e + 1) * ep].any(axis=0)
            sink, need = self._isl.sink_plan(self.C[e * ep:(e + 1) * ep],
                                             alive=alive_e)
            self._sink_cache[e] = (
                torch.as_tensor(sink.astype(np.int64), device=self.device),
                torch.as_tensor(need, device=self.device))
        return self._sink_cache[e]

    def _transfer_operands(self, i: int) -> dict:
        """Window i's operands of both transfer halves
        (`core/transfers.py`): the alive mask of a fault run, the sink
        plan of a sink-relay run."""
        kw = {}
        if self._alive_dev is not None:
            kw["alive"] = self._alive_dev[i]
        if self._isl_mode == "sink":
            kw["sink"], kw["need_hops"] = self._sink_plan(i)
        return kw

    def on_uploads(self, i: int, conn: np.ndarray) -> int:
        """Connected satellites hand their pending update to the GS buffer
        (the shared `upload_step` transition on the device, gated on the
        window's grants under a link budget). Under sink relaying the ring
        relay advances first and the upload runs on sink-indexed effective
        connectivity; under gossip, the neighbour exchange runs before it
        (at every hop period). In a fault run the window's reviving
        satellites re-enter first (`fault_reset`), and dead ones neither
        gossip nor ride their sink's contact. Returns the buffer
        occupancy."""
        res = self.result
        conn_dev = torch.as_tensor(np.asarray(conn, bool), device=self.device)
        kw = self._transfer_operands(i)
        if self._trace is not None:
            kw["revive"] = self._revive_dev[i]
        if self._isl_mode == "gossip" and \
                i % max(self._isl.relay_windows, 1) == 0:     # a hop window
            kw["gossip"] = self._gossip_dev + (True,)
        self.state, info = TR.window_upload(self.state, self.ig, conn_dev,
                                            self._gate(i), **kw)
        n_conn, n_idle, n_buf = torch.stack(
            [info["n_connected"], info["n_idle"], info["n_buffered"]]
        ).tolist()
        res.total_connections += n_conn
        res.idle_connections += n_idle
        return n_buf

    def on_decide(self, i: int, n_buf: int) -> bool:
        """Ask the scheduler for the aggregation indicator a^i. It plans on
        the plan view (`_plan_C`, `_plan_link`): under a blind fault trace
        the clean world, while the run executes the masked one."""
        return self.scheduler.decide(
            i, n_in_buffer=n_buf, K=self.K, state=self.state, ig=self.ig,
            connectivity=self._plan_C, status=self.status,
            link=self._plan_link)

    def on_aggregate(self, i: int) -> None:
        """Apply the staleness-compensated buffered update (eq. 4).

        Buffered satellites are grouped by base model version (and batch
        shape); each group trains as one batched client update that writes
        its deltas into its rows of one update buffer, and the weighted
        reduction is one launch of the aggregation kernel over the flat
        model (`aggregate_flat`), reading the rows in the staleness
        vector's order where they lie. The buffer's base versions come to
        the host once here — the grouping and the batch indices are host
        work."""
        cfg = self.config
        buffered = self.state.buffered.cpu().numpy()
        ks = np.flatnonzero(buffered >= 0)
        stal = (self.ig - buffered[ks]).astype(np.int64)
        updates, rows = self._train_buffered(ks, buffered, round_rng=i)
        w = aggregation_weights(torch.as_tensor(stal, device=self.device),
                                cfg.alpha) * cfg.server_lr
        flat = self.layout.flat(tree_leaves(self.params))
        self.params = self._view(aggregate_flat(flat, updates, w, rows))
        self.state, _, _ = SS.aggregate_step(self.state, self.ig, True,
                                             s_max=cfg.s_max, collect="none")
        self.ig += 1
        self.store.put(self.ig, self.params)
        refs = np.concatenate([self.state.pending.cpu().numpy(), buffered])
        refs = refs[refs >= 0]
        self.store.prune(int(refs.min()) if refs.size else self.ig)
        res = self.result
        res.num_global_updates += 1
        res.num_aggregated_gradients += len(ks)
        np.add.at(res.staleness_hist, np.clip(stal, 0, cfg.s_max), 1)
        self._emit("on_aggregate_end", i,
                   {"ig": self.ig, "n_aggregated": len(ks),
                    "staleness": stal.tolist()})

    def _train_buffered(self, ks: np.ndarray, buffered: np.ndarray, *,
                        round_rng: int):
        """Compute the buffered satellites' updates, batched by base model
        version, into the rows of one (len(ks), N) buffer (`_update_rows`),
        a group's rows after the previous group's. Returns (updates, rows):
        the buffer and, for each satellite of `ks` (the staleness vector's
        order), the int32 index of its row.

        Per base version: one checkpoint fetch, one batched data gather
        (`adapter.client_batch_many` when available), one batched client
        update. Satellites the batched gather can't serve (empty shards,
        off-modal batch widths) fall back to per-satellite batches, grouped
        by shape."""
        cfg = self.config
        by_base = {}   # base version -> [(row in ks, client id)]
        for row, k in enumerate(ks):
            by_base.setdefault(int(buffered[k]), []).append((row, int(k)))
        many = getattr(self.adapter, "client_batch_many", None)
        updates = self._update_rows(len(ks))
        order, zero_rows = [], []     # order: the row in ks of each row

        def run(base, batches, rows_in_ks):
            r0 = len(order)
            self._run_batched(base, batches, out=self._view(
                updates[r0:r0 + len(rows_in_ks)]))
            order.extend(rows_in_ks)
        for base_v, members in by_base.items():
            base = self.store.get(base_v)       # fetched once per group
            rest = range(len(members))
            if many is not None:
                stacked, used = many([k for _, k in members], round_rng,
                                     cfg.batch_size, cfg.local_steps)
                if used:
                    run(base, stacked, [members[u][0] for u in used])
                    used = set(used)
                    rest = [j for j in rest if j not in used]
            by_shape = {}  # leftovers / no batched gather: group by shape
            for j in rest:
                row, k = members[j]
                batch = self.adapter.client_batch(k, round_rng,
                                                  cfg.batch_size,
                                                  cfg.local_steps)
                if batch is None:
                    zero_rows.append(row)
                    continue
                sig = tuple(tuple(t.shape) for t in batch)
                by_shape.setdefault(sig, []).append((row, batch))
            for mem in by_shape.values():
                batches = tuple(torch.stack(ts)
                                for ts in zip(*[b for _, b in mem]))
                run(base, batches, [row for row, _ in mem])
        if zero_rows:
            updates[len(order):].zero_()
            order += zero_rows
        rows = np.argsort(np.asarray(order)).astype(np.int32)
        return updates, torch.as_tensor(rows, device=self.device)

    def _update_rows(self, m: int):
        """Rows [0, m) of the engine's update buffer, (m, N) in the params'
        dtype, rows a multiple of 64 elements apart. The buffer is kept
        between aggregations and grows to the largest buffer seen; it
        starts zeroed, so the elements between leaves (`FlatLayout`),
        which no update writes, stay 0."""
        n = self.layout.size
        if self._updates is None or self._updates.shape[0] < m:
            dtype = tree_leaves(self.params)[0].dtype
            self._updates = torch.zeros((m, -(-n // 64) * 64), dtype=dtype,
                                        device=self.device)
        return self._updates[:m, :n]

    def _view(self, flat):
        """The parameter tree as views of `flat` (..., N)."""
        return tree_unflatten(self._structure, self.layout.views(flat))

    def _run_batched(self, base, batches, out=None):
        """Train a group of satellites as one batched client update,
        writing the deltas into `out` (a tree of (m, *shape) views) when
        given. (The reference pads groups to powers of two so that `jit`
        compiles few shapes; PyTorch runs eagerly and needs no
        padding.)"""
        return self._batched_update(base, batches, out=out)

    def on_downloads(self, i: int, conn: np.ndarray) -> None:
        """Connected satellites fetch the current global model and start a
        fresh local round on it (the shared `download_step` transition,
        gated on the window's grants under a link budget). Under sink
        relaying the plane downloads through its sink's contact (the relay
        advanced at the upload already; dead satellites, in a fault run,
        download nothing) and fresh rounds reset the relay counter."""
        conn_dev = torch.as_tensor(np.asarray(conn, bool), device=self.device)
        self.state = TR.window_download(self.state, self.ig, conn_dev,
                                        self._gate(i),
                                        **self._transfer_operands(i))

    # --------------------------------------------------------------- eval

    def evaluate(self, i: int) -> bool:
        """Eval checkpoint; returns True when the run should stop (target
        accuracy reached and stop_at_target is set)."""
        cfg, res = self.config, self.result
        acc = self.adapter.accuracy(self.params)
        self.status = float(self.adapter.val_loss(self.params))
        res.accuracy.append(acc)
        res.val_loss.append(self.status)
        res.eval_windows.append(i)
        self._emit("on_eval", i, {
            "window": i, "day": res.days(i), "accuracy": acc,
            "val_loss": self.status,
            "global_updates": res.num_global_updates,
            "aggregated_gradients": res.num_aggregated_gradients,
        })
        if (cfg.target_acc is not None and acc >= cfg.target_acc
                and res.time_to_target_days is None):
            res.time_to_target_days = res.days(i)
            if cfg.stop_at_target:
                return True
        return False

    # ------------------------------------------------------------ callbacks

    def _emit(self, event: str, *args) -> None:
        for cb in self.callbacks:
            handler = getattr(cb, event, None)
            if handler is not None:
                handler(self, *args)
