"""Event-driven FL simulation engine over the connectivity sequence
(Algorithm 1), decomposed into overridable protocol steps.

Time advances in T0 windows (15 min each). At window i the GS:
  receives pending updates from connected satellites (`on_uploads`), asks
  the scheduler whether to aggregate a^i (`on_decide`), applies the
  staleness-compensated update of eq. 4 when a^i = 1 (`on_aggregate`), and
  broadcasts the current model (`on_downloads`).

The port of `repro.fl.engine`, with the protocol state (`SatState`),
the model, the checkpoints and the client data on the run's device. Two
execution strategies, the reference's, give the same bits:
  * the chunked **fast loop** (the default): when no protocol step is
    overridden and the scheduler offers a `device_plan`, the windows
    between two aggregation events run as one scan on the device
    (`_scan_windows`), which freezes at the first window whose indicator
    fires; its per-window counters come to the host once a scan, the host
    trains and aggregates that window, and the next scan starts after it.
    On a CUDA device each scan is one replay of a CUDA graph
    (`ChunkGraphs`: one graph per static shape of the scan, the
    counterpart of the reference's `jax.jit` of its `lax.scan`), counted
    in `graph_counts`; on the CPU the same function runs eagerly;
  * the per-window **host loop** (`_run_window`): `on_uploads`,
    `on_decide`, `on_aggregate`, `on_downloads` through the same
    transitions, with one small device-to-host read a window. It runs
    for `EngineConfig(fast_loop=False)`, a subclass that overrides a
    step, and a window whose scheduler offers no plan.

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
to the device once per run.

A satellite-axis mesh (`mesh=`, `repro_torch.core.mesh.sim_mesh`) shards
the fast loop's scans over the ranks of a process group: every rank
holds the whole state padded to the mesh and its own columns of the
run's tables, scans its columns with exact integer collectives as the
only cross-rank traffic, and gathers the state after each scan; the
host loop, client training, the aggregation and evaluation run on every
rank on the padded state, as the reference's host loop runs on global
arrays. Any mesh gives the trajectory of `mesh=None` bit for bit.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointStore
from repro_torch.core import faults as FT
from repro_torch.core import mesh as MM
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

# Upper bound on the windows of one scan: chunks are bucketed to powers of
# two up to this, so a run captures O(log) scan shapes a scheduler kind,
# and the device copies of the run's matrices carry this many padding rows
_MAX_CHUNK = 128

# The fast loop's CUDA graphs, beside `repro_torch.kernels.launch_counts`:
# `captures` counts graphs captured, `replays` chunk scans replayed
graph_counts = {"captures": 0, "replays": 0}


def _state_where(pred, a: SS.SatState, b: SS.SatState) -> SS.SatState:
    """Column by column `where(pred, a, b)` over the columns the state
    carries (None stays None)."""
    return SS.SatState(*(None if x is None else torch.where(pred, x, y)
                         for x, y in zip(a, b)))


def _gather_state(state, axis):
    """The whole state from every rank's columns: one all-gather of the
    stacked (int32) columns."""
    present = [x for x in state if x is not None]
    cols = iter(MM.all_gather(torch.stack(present), axis).unbind(0))
    return SS.SatState(*(None if x is None else next(cols) for x in state))


def _scan_windows(state, ig, C_dev, i0, n_valid, ind_args, link_dev,
                  isl_dev=None, faults_dev=None, *, indicator, horizon,
                  isl_mode=None, axis=None):
    """Advance the protocol over `horizon` windows from absolute window
    `i0`, freezing at the first window whose aggregation indicator fires
    (post-upload, pre-aggregation: the engine trains and aggregates on the
    host, then scans on). The port of the reference's `_scan_impl`, built
    from the transitions the host loop and the sweep run
    (`core/transfers.py`'s two halves).

    `ig`, `i0` and `n_valid` are 0-d int32 tensors on the run's device:
    `ig` holds for the whole scan (no aggregation happens in it), and
    windows at offset >= `n_valid` are padding (a bucketed horizon) that
    leave the state as it is. `C_dev` is the run's (W + _MAX_CHUNK, K)
    connectivity on the device, padded with all-false rows so a scan never
    reads past it; `link_dev` is None or ``(grants (W + _MAX_CHUNK, K)
    int32, need_up, need_dn)``; `faults_dev` None or ``(revive, alive)``,
    both padded likewise. `isl_mode` "sink" takes ``isl_dev = (sink,
    need_hops)`` (one election for the whole chunk: the engine clips
    chunks to election epochs), "gossip" ``(nxt, prv, left, right,
    period)`` with `period` a 0-d int32 tensor.

    `axis` is a satellite-axis mesh's group (`repro_torch.core.mesh`) or
    None. Under a mesh `state` and the ISL index arrays are the whole
    padded (Kp,) vectors, the same on every rank, while `C_dev` and the
    grant and fault tables hold the rank's columns: the scan runs on the
    rank's columns of the state (the counters are psums, the sink and
    neighbour lookups gather the rows they index; the reference's
    `_scan_impl` under `shard_map`) and all-gathers the state columns at
    the end, so every rank returns the whole state and the same counters.

    Nothing here reads the device, so the function runs eagerly on the CPU
    and is captured whole into a CUDA graph on the card (`ChunkGraphs`).
    Returns (state, counters (horizon, 4) int32) with per-window
    [n_connected, n_idle, n_buffered, a]; rows after the event row are
    garbage the caller ignores."""
    device = C_dev.device
    if axis is not None:
        state = SS.SatState(*(None if x is None else MM.local(x, axis)
                              for x in state))
        if isl_dev is not None:     # the gossip period stays 0-d
            isl_dev = tuple(MM.local(x, axis) if x.dim() else x
                            for x in isl_dev)
    ts = i0 + torch.arange(horizon, dtype=i0.dtype, device=device)
    conn = C_dev.index_select(0, ts)
    grant = None if link_dev is None else link_dev[0].index_select(0, ts)
    revive = alive = None
    if faults_dev is not None:
        revive = faults_dev[0].index_select(0, ts)
        alive = faults_dev[1].index_select(0, ts)
    done = torch.zeros((), dtype=torch.bool, device=device)
    rows = []
    for j in range(horizon):
        t = ts[j]
        live = ~done & (t - i0 < n_valid)
        gate = None if grant is None \
            else SS.LinkGate(grant[j], link_dev[1], link_dev[2])
        kw = {} if alive is None else {"alive": alive[j]}
        if isl_mode == "sink":
            kw["sink"], kw["need_hops"] = isl_dev
        gossip = None
        if isl_mode == "gossip":
            period = isl_dev[4]
            gossip = tuple(isl_dev[:4]) + ((period <= 1)
                                           | (t % period == 0),)
        up_st, info = TR.window_upload(
            state, ig, conn[j], gate, gossip=gossip, **kw,
            revive=None if revive is None else revive[j], axis_name=axis)
        n_buf = info["n_buffered"]
        a = live & indicator(t, n_buf, ind_args) & (n_buf > 0)
        dl_st = TR.window_download(up_st, ig, conn[j], gate, **kw,
                                   axis_name=axis)
        state = _state_where(live, _state_where(a, up_st, dl_st), state)
        rows.append(torch.stack([info["n_connected"], info["n_idle"], n_buf,
                                 a.to(torch.int32)]))
        done = done | a
    if axis is not None:
        state = _gather_state(state, axis)
    return state, torch.stack(rows)


class _Graph(NamedTuple):
    graph: object          # torch.cuda.CUDAGraph
    inputs: list           # static input buffers, copied into per replay
    state: SS.SatState     # static outputs, overwritten by every replay
    counters: torch.Tensor
    keep: tuple            # the run constants the graph reads in place
    collectives: Counter   # the collectives one replay runs (a mesh's)


class ChunkGraphs:
    """`_scan_windows` as CUDA graphs, one per static key: the indicator,
    the bucketed horizon, the ISL mode, which state columns exist, the
    shapes and dtypes of the indicator's args and the ISL operands, and
    the run's constant tensors (connectivity, grants and their needs,
    fault masks), which the graph reads in place. The counterpart of the
    reference's `jax.jit` of `_scan_windows` with its static arguments.

    A graph is captured at its key's first call (a warm-up run on a side
    stream, then the capture, into one memory pool that all the graphs
    share) and replayed after copying the call's state columns, `ig`,
    `i0`, `n_valid`, indicator args and ISL operands into its static input
    buffers. The outputs are copied out of the graph's buffers before
    the call returns, so a later replay of any graph leaves them alone. A
    failed capture raises: nothing falls back to the eager function.
    Called like `_scan_windows`, with `ig`, `i0` and `n_valid` as ints or
    0-d tensors.

    Under a mesh (`axis`, part of the key) the graph holds the scan's
    NCCL collectives, captured in "thread_local" mode (so that the
    process group's watchdog thread may go on querying its events). A
    replay runs them again: it adds the captured collectives to
    `repro_torch.core.mesh.collective_counts` (the capture itself adds
    none, the warm-up run counts as it runs)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"ChunkGraphs captures CUDA graphs, not on "
                             f"{self.device}")
        self.pool = None
        self.graphs = {}

    def __call__(self, state, ig, C_dev, i0, n_valid, ind_args, link_dev,
                 isl_dev=None, faults_dev=None, *, indicator, horizon,
                 isl_mode=None, axis=None):
        arg_leaves, arg_structure = tree_flatten(ind_args)
        isl_ops = list(isl_dev or ())
        consts = [C_dev] + ([] if link_dev is None else [link_dev[0]]) \
            + list(faults_dev or ())
        present = tuple(x is not None for x in state)
        key = (indicator, horizon, isl_mode, present, repr(arg_structure),
               tuple((tuple(x.shape), x.dtype) for x in arg_leaves
                     + isl_ops),
               tuple((x.data_ptr(), tuple(x.shape), x.dtype)
                     for x in consts),
               None if link_dev is None else (int(link_dev[1]),
                                              int(link_dev[2])),
               None if axis is None else id(axis))
        cols = [x for x in state if x is not None]
        dynamic = cols + [ig, i0, n_valid] + arg_leaves + isl_ops
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(
                dynamic, present, arg_structure, len(arg_leaves), C_dev,
                link_dev, faults_dev, indicator=indicator, horizon=horizon,
                isl_mode=isl_mode, keep=tuple(consts), axis=axis)
        for dst, src in zip(g.inputs, dynamic):
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                dst.fill_(src)
        g.graph.replay()
        graph_counts["replays"] += 1
        MM.collective_counts.update(g.collectives)
        return (SS.SatState(*(None if x is None else x.clone()
                              for x in g.state)), g.counters.clone())

    def _capture(self, dynamic, present, arg_structure, n_args, C_dev,
                 link_dev, faults_dev, *, indicator, horizon, isl_mode,
                 keep, axis):
        # the static inputs live on the card (a CPU scalar would be baked
        # into the graph as a constant), outside the graphs' pool
        inputs = [x.to(self.device, copy=True) if isinstance(x, torch.Tensor)
                  else torch.tensor(x, dtype=torch.int32, device=self.device)
                  for x in dynamic]
        n_cols = sum(present)
        cols = iter(inputs[:n_cols])
        st = SS.SatState(*(next(cols) if p else None for p in present))
        ig, i0, n_valid = inputs[n_cols:n_cols + 3]
        args = tree_unflatten(arg_structure,
                              inputs[n_cols + 3:n_cols + 3 + n_args])
        isl_ops = tuple(inputs[n_cols + 3 + n_args:]) or None

        def scan():
            return _scan_windows(
                st, ig, C_dev, i0, n_valid, args, link_dev, isl_ops,
                faults_dev, indicator=indicator, horizon=horizon,
                isl_mode=isl_mode, axis=axis)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            scan()                                  # warm-up
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        mode = "global" if axis is None else "thread_local"
        before = Counter(MM.collective_counts)
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode=mode):
            out_state, counters = scan()
        graph_counts["captures"] += 1
        captured = MM.collective_counts - before
        MM.collective_counts.subtract(captured)     # captured, not run
        return _Graph(graph, inputs, out_state, counters, keep, captured)


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
    # False forces the per-window host loop even where the chunked fast
    # loop would apply — e.g. for callbacks that must observe the device
    # state at every single window boundary
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

    Execution-strategy selection (both strategies give the same bits):
      * the chunked **fast loop** (`_run_chunk` over `_scan_windows`) runs
        when ALL of — `EngineConfig.fast_loop` is True (the default), no
        protocol step is overridden in a subclass, and
        `Scheduler.device_plan` returns a plan for the current window;
        on a CUDA device each scan is a CUDA graph replay (`ChunkGraphs`,
        `graph_counts`), elsewhere the function runs eagerly;
      * otherwise the window goes through the per-window **host loop**
        (`_run_window`): one `on_uploads`/`on_decide`/`on_aggregate`/
        `on_downloads` cycle through the same transitions.
    Fast-loop chunks are clipped to eval boundaries (where `status`
    changes), the plan's horizon, `_MAX_CHUNK` and the sink election
    epoch; on a card they are bucketed to powers of two, so a run
    captures O(log) scan shapes (the padding windows change nothing, so
    the CPU's eager scans skip them). The aggregation stays on the host
    (`on_aggregate`, one aggregation-kernel launch each). Under the fast
    loop `on_window_end` callbacks see the state at the end of the scan,
    as in the reference; a stop they request mid-chunk replays the
    chunk's prefix, so the run freezes one window after the request
    under both strategies.

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
      mesh: optional satellite-axis `DeviceMesh`
        (`repro_torch.core.mesh.sim_mesh`) on the run's device type. The
        state is padded to a multiple of the mesh's size with
        never-connected satellites (`repro_torch.core.mesh.pad_state`),
        each rank keeps its own columns of the fast loop's device tables,
        the fast loop's scans run sharded (`_scan_windows(axis=...)`) with
        exact integer collectives as the only cross-rank traffic, the
        host loop runs the padded state on every rank, and the host views
        and the schedulers' state strip the padding: any mesh run is the
        `mesh=None` run bit for bit. Every rank of the mesh runs the
        engine with the same arguments. A mesh on another device type
        than the run's raises.
    """

    def __init__(self, C: np.ndarray, adapter, scheduler: Scheduler,
                 config: Optional[EngineConfig] = None, *,
                 callbacks: Sequence = (), init_params=None, device=None,
                 link_budget=None, isl=None, faults=None, mesh=None,
                 **overrides):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a mesh on {mesh.device_type} cannot run an "
                             f"engine on {self.device}")
        self.mesh = mesh
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
        # the padded satellite count of every device-side vector and table
        self._Kp = self.K if mesh is None else MM.padded_size(self.K, mesh)

    # ------------------------------------------------------------------ API

    def request_stop(self) -> None:
        """Ask the engine to stop after the current window (callbacks use
        this for early stopping)."""
        self._stop_requested = True

    def _host(self, x) -> Optional[np.ndarray]:
        """A state column on the host, the mesh's padding stripped."""
        return None if x is None else x[..., :self.K].cpu().numpy()

    @property
    def version(self) -> np.ndarray:
        """Host mirror of the last global version each satellite received.
        Read-only diagnostic — the authoritative state is `self.state`."""
        return self._host(self.state.version)

    @property
    def pending(self) -> np.ndarray:
        """Host mirror of each satellite's pending-update base version."""
        return self._host(self.state.pending)

    @property
    def buffered_base(self) -> np.ndarray:
        """Host mirror of the GS buffer's per-satellite base versions."""
        return self._host(self.state.buffered)

    @property
    def transfer_progress(self) -> Optional[np.ndarray]:
        """Host mirror of each satellite's in-progress transfer units (None
        unless the run models a link budget)."""
        return self._host(self.state.progress)

    @property
    def relay_units(self) -> Optional[np.ndarray]:
        """Host mirror of each satellite's accumulated ISL hop units (None
        unless the run relays through sink satellites)."""
        return self._host(self.state.relay)

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
        # a scheduler that simulates on the device (FedSpace's eq.-13
        # search) shards it over the run's mesh
        self.scheduler.mesh = self.mesh
        self.scheduler.reset()
        self._stop_requested = False
        self._axis = None if self.mesh is None else MM.mesh_axis(self.mesh)
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
        if self.mesh is not None:
            self.state = MM.pad_state(self.state, self._Kp)
        # the fast loop runs when no protocol step is overridden (and
        # the scheduler offers a plan, asked window by window in `run`)
        self._fast_ok = cfg.fast_loop and all(
            getattr(type(self), m) is getattr(SimulationEngine, m)
            for m in ("on_uploads", "on_decide", "on_aggregate",
                      "on_downloads"))
        # the run's matrices go to the device once; under the fast loop
        # each carries _MAX_CHUNK all-false (zero) rows after the horizon,
        # so a bucketed scan never reads past it. Under a mesh a rank keeps
        # its own columns of the padded tables, which only the scans read
        # (the host loop takes its rows from the host, `_window_row`)
        pad = _MAX_CHUNK if self._fast_ok else 0
        tables = self._fast_ok or self.mesh is None

        def on_device(rows, dtype):
            if not tables:
                return None
            rows = np.asarray(rows[:self.num_windows], dtype)
            if self._axis is not None:
                rows = MM.pad_axis(rows, self._Kp)[
                    :, MM.local_slice(self._Kp, self._axis)]
            if pad:
                rows = np.concatenate(
                    [rows, np.zeros((pad, rows.shape[1]), dtype)])
            return torch.as_tensor(np.ascontiguousarray(rows),
                                   device=self.device)
        self._C_dev = on_device(self.C, bool) if self._fast_ok else None
        # the run's link gates: the executed grants on the device for the
        # transitions, and host gates for the schedulers — the executed
        # one, and the plan view they decide on (a blind fault run's clean
        # grants)
        self._link = self._plan_link = self._grants_dev = None
        self._link_dev = None
        if linked:
            b = self.link_budget
            self._link = SS.LinkGate(self._grants, int(b.need_up),
                                     int(b.need_dn))
            self._plan_link = self._link \
                if self._plan_grants is self._grants \
                else SS.LinkGate(self._plan_grants, int(b.need_up),
                                 int(b.need_dn))
            self._grants_dev = on_device(self._grants, np.int32)
            self._link_dev = (self._grants_dev, int(b.need_up),
                              int(b.need_dn))
        # fault masks on the device (None without a trace); `_alive` stays
        # on the host for the sink elections
        self._alive = self._alive_dev = self._revive_dev = None
        self._faults_dev = None
        if self._trace is not None:
            self._alive = np.asarray(self._trace.alive[:self.num_windows],
                                     bool)
            self._alive_dev = on_device(self._alive, bool)
            self._revive_dev = on_device(self._trace.revive, bool)
            self._faults_dev = (self._revive_dev, self._alive_dev)
        # ISL device arrays: sink plans per election epoch (made at the
        # epoch's first window), the gossip neighbours and hop period once
        # per run
        self._sink_cache = {}
        self._gossip_dev = self._gossip_period = None
        if self._isl_mode == "gossip":
            # satellites of the mesh's padding are their own neighbours
            topo = self._isl.topology
            idx = np.arange(self._Kp)
            cross = self._isl.cross_plane
            self._gossip_dev = tuple(
                torch.as_tensor(np.concatenate(
                    [np.asarray(a, np.int64), idx[self.K:]]),
                    device=self.device)
                for a in (topo.nxt, topo.prv,
                          topo.left if cross else idx[:self.K],
                          topo.right if cross else idx[:self.K]))
            self._gossip_period = torch.tensor(
                max(self._isl.relay_windows, 1), dtype=torch.int32,
                device=self.device)
        # the fast loop's chunk scans: CUDA graphs on a card, the eager
        # function elsewhere; `loop_counts` counts this run's chunks, scans
        # and the engine's own device-to-host reads
        self._graphs = ChunkGraphs(self.device) \
            if self._fast_ok and self.device.type == "cuda" else None
        self.loop_counts = {"chunks": 0, "scans": 0, "host_reads": 0}
        self.result = SimResult(scheme=self.scheduler.name,
                                target_acc=cfg.target_acc)
        self.result.staleness_hist = np.zeros(cfg.s_max + 1, np.int64)
        self.status = float(self.adapter.val_loss(self.params))

    def run(self) -> SimResult:
        """Execute the run: `prepare()`, then advance windows under the
        selected strategy until the horizon, a stop request, or the
        target accuracy. Returns the populated `SimResult`."""
        self.prepare()
        try:
            self._emit("on_run_begin")
            i = 0
            while i < self.num_windows:
                chunk = self._fast_chunk_plan(i) if self._fast_ok else None
                if chunk is None:
                    i, stop = self._run_window(i)
                else:
                    i, stop = self._run_chunk(i, *chunk)
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

    # --------------------------------------------------- chunked fast loop

    def _fast_chunk_plan(self, i: int):
        """Ask the scheduler for a device-side indicator valid from window
        i; clip the chunk to the eval boundary (where `status` changes),
        the plan's horizon, `_MAX_CHUNK` and, under sink relaying, the
        election epoch. Returns (indicator, args, end) or None."""
        if self._trace is not None:
            # reviving satellites re-enter before planning (idempotent:
            # the scan applies the same reset at this window)
            self.state = FT.fault_reset(self.state, self._revive_row(i))
        extra = {} if self._trace is None else {
            "exec_connectivity": self.C, "exec_link": self._link}
        plan = self.scheduler.device_plan(
            i, K=self.K, state=self._plan_state(), ig=self.ig,
            connectivity=self._plan_C, status=self.status,
            link=self._plan_link, **extra)
        if plan is None:
            return None
        fn, args, horizon = plan
        end = i + (int(horizon) if horizon is not None
                   else self.num_windows - i)
        ev = self.config.eval_every
        end = min(end, self.num_windows, (i // ev + 1) * ev, i + _MAX_CHUNK)
        if self._isl_mode == "sink":
            # one sink election a scan: clip chunks to election epochs
            ep = self._isl.epoch
            end = min(end, (i // ep + 1) * ep)
        return fn, args, end

    def _scan(self, state, w: int, n_valid: int, fn, args, isl_dev,
              horizon: int):
        """One scan of `horizon` windows from w, the first `n_valid` of
        them live: a graph replay on a card, the eager `_scan_windows`
        elsewhere. Returns (state, counters), both the engine's own."""
        self.loop_counts["scans"] += 1
        kw = dict(indicator=fn, horizon=horizon, isl_mode=self._isl_mode,
                  axis=self._axis)
        if self._graphs is not None:
            return self._graphs(state, self.ig, self._C_dev, w, n_valid,
                                args, self._link_dev, isl_dev,
                                self._faults_dev, **kw)

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=self.device)
        return _scan_windows(state, i32(self.ig), self._C_dev, i32(w),
                             i32(n_valid), args, self._link_dev, isl_dev,
                             self._faults_dev, **kw)

    def _run_chunk(self, i: int, fn, args, end: int):
        """Advance windows [i, end) through scans on the device, back on
        the host exactly at aggregation events. One device-to-host read of
        the per-window counters a scan; the protocol's integers and the
        model's bits are the host loop's. Returns (next window, stop)."""
        cfg, res = self.config, self.result
        self.loop_counts["chunks"] += 1
        args = tree_map(lambda x: torch.as_tensor(x, device=self.device),
                        args)
        w = i
        while w < end:
            H = end - w
            # a card's scans are bucketed to powers of two (one graph a
            # bucket); the CPU's eager scan runs just the chunk's windows
            bucket = H if self._graphs is None else 1 << (H - 1).bit_length()
            if self._isl_mode == "sink":
                isl_dev = self._sink_plan(w)
            elif self._isl_mode == "gossip":
                isl_dev = self._gossip_dev + (self._gossip_period,)
            else:
                isl_dev = None
            prev_state = self.state
            self.state, counters = self._scan(prev_state, w, H, fn, args,
                                              isl_dev, bucket)
            counters = counters[:H].tolist()
            self.loop_counts["host_reads"] += 1
            advanced = H
            for j in range(H):
                n_conn, n_idle, _, a = counters[j]
                res.total_connections += n_conn
                res.idle_connections += n_idle
                res.windows_run = w + j + 1
                if a:
                    self.on_aggregate(w + j)
                    self.on_downloads(w + j, self.C[w + j])
                stop = False
                if (w + j + 1) % cfg.eval_every == 0 \
                        or w + j == self.num_windows - 1:
                    stop = self.evaluate(w + j)
                self._emit("on_window_end", w + j)
                if stop or self._stop_requested:
                    if not a and j + 1 < H:
                        # a stop mid-chunk: the scan advanced the state past
                        # this window; replay the prefix from the saved state
                        # (no event fired in it, so the rescan repeats it
                        # exactly), so the run freezes one window after the
                        # request, not at the chunk's end
                        self.state, _ = self._scan(prev_state, w, j + 1, fn,
                                                   args, isl_dev, bucket)
                    return w + j + 1, True
                if a:        # the scan froze at the event; rescan after it
                    advanced = j + 1
                    break
            w += advanced
        return w, False

    # -------------------------------------------------------- protocol steps

    def _plan_state(self) -> SS.SatState:
        """The schedulers' (K,) view of the protocol state: the mesh's
        padding stripped, so `device_plan` and `decide` see the world at
        its own satellite count."""
        if self._Kp == self.K:
            return self.state
        return SS.SatState(*(None if x is None else x[..., :self.K]
                             for x in self.state))

    def _host_row(self, row, dtype) -> torch.Tensor:
        """A host (K,) row on the device, padded to the mesh (fill 0)."""
        row = np.asarray(row, dtype)
        if self._Kp != self.K:
            row = MM.pad_axis(row, self._Kp)
        return torch.as_tensor(row, device=self.device)

    def _window_row(self, table, host, i: int, dtype) -> torch.Tensor:
        """Window i's row of a run table for the host loop: a row of the
        device table, or under a mesh (whose device tables hold a rank's
        columns) the host row, padded, on the device."""
        if self.mesh is None:
            return table[i]
        return self._host_row(host[i], dtype)

    def _revive_row(self, i: int) -> torch.Tensor:
        return self._window_row(self._revive_dev, self._trace.revive, i,
                                bool)

    def _gate(self, i: int):
        """The device `LinkGate` of window i (None without a link
        budget): a row of the run's grants on the device."""
        if self._link is None:
            return None
        return SS.LinkGate(self._window_row(self._grants_dev, self._grants,
                                            i, np.int32),
                           self._link.need_up, self._link.need_dn)

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
            # satellites of the mesh's padding are their own sinks at
            # distance 0 (never connected, so inert)
            sink = np.concatenate([sink.astype(np.int64),
                                   np.arange(self.K, self._Kp)])
            self._sink_cache[e] = (
                torch.as_tensor(sink, device=self.device),
                self._host_row(need, np.int32))
        return self._sink_cache[e]

    def _transfer_operands(self, i: int) -> dict:
        """Window i's operands of both transfer halves
        (`core/transfers.py`): the alive mask of a fault run, the sink
        plan of a sink-relay run."""
        kw = {}
        if self._alive is not None:
            kw["alive"] = self._window_row(self._alive_dev, self._alive, i,
                                           bool)
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
        conn_dev = self._host_row(conn, bool)
        kw = self._transfer_operands(i)
        if self._trace is not None:
            kw["revive"] = self._revive_row(i)
        if self._isl_mode == "gossip" and \
                i % max(self._isl.relay_windows, 1) == 0:     # a hop window
            kw["gossip"] = self._gossip_dev + (True,)
        self.state, info = TR.window_upload(self.state, self.ig, conn_dev,
                                            self._gate(i), **kw)
        n_conn, n_idle, n_buf = torch.stack(
            [info["n_connected"], info["n_idle"], info["n_buffered"]]
        ).tolist()
        self.loop_counts["host_reads"] += 1
        res.total_connections += n_conn
        res.idle_connections += n_idle
        return n_buf

    def on_decide(self, i: int, n_buf: int) -> bool:
        """Ask the scheduler for the aggregation indicator a^i. It plans on
        the plan view (`_plan_C`, `_plan_link`): under a blind fault trace
        the clean world, while the run executes the masked one."""
        return self.scheduler.decide(
            i, n_in_buffer=n_buf, K=self.K, state=self._plan_state(),
            ig=self.ig,
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
        self.loop_counts["host_reads"] += 2      # here and the pruning's
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
        conn_dev = self._host_row(conn, bool)
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
