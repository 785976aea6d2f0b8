"""Declarative experiment layer: `FLExperiment` (what to run, as data) and
`Federation` (the wired-up world that runs it), the port of
`repro.fl.api`.

One experiment = constellation x dataset x partition x adapter x scheduler
x training/link options, every component referenced by registry name
(`repro_torch.fl.registry`):

    exp = FLExperiment(
        constellation=ConstellationConfig(num_satellites=40, days=3.0),
        dataset=DatasetConfig(num_train=4000, num_val=1000, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="mlp", params={"hidden": 48}),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 20}),
        train=EngineConfig(local_steps=16, client_lr=1.0, target_acc=0.35),
    )
    result = Federation.from_experiment(exp).run()      # on the card
    Federation.from_experiment(exp, device="cpu").run()  # on the CPU

A world is built on one device: "cuda" unless the caller asks for the CPU,
and building raises when no CUDA device is present. The parts of the
reference this slice does not have yet — FedSpace scheduling, link
budgets and uplink compression, ISLs, faults — raise NotImplementedError
naming their slice; nothing silently runs something else instead.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Union

import numpy as np

from repro_torch.core import connectivity as CN
from repro_torch.data.fmow import FmowSpec, SyntheticFmow
from repro_torch.data.partition import iid_partition, noniid_partition
from repro_torch.data.pipeline import make_clients
import repro_torch.core.scheduler  # noqa: F401 — registers the schedulers
import repro_torch.fl.adapters  # noqa: F401 — registers the built-in adapters
from repro_torch.device import resolve_device
from repro_torch.fl.engine import EngineConfig, SimResult, SimulationEngine
from repro_torch.fl.registry import (ADAPTERS, PARTITIONS, SCHEDULERS,
                                     register_partition)

__all__ = ["ConstellationConfig", "DatasetConfig", "PartitionConfig",
           "AdapterConfig", "SchedulerConfig", "LinkConfig", "FLExperiment",
           "Federation"]


# --------------------------------------------------------------------------
# sub-configs


@dataclass
class ConstellationConfig:
    """Constellation + simulated horizon for the connectivity sequence.

    Two ways to pick the constellation:
      * ad hoc: `num_satellites` (+ `spec_overrides`) builds a single-shell
        Planet-Flock-like spec;
      * by preset: `preset` names a registered scenario
        (`repro_torch.fl.registry.CONSTELLATIONS` — "flock191",
        "starlink40/120/400/1000", ...) whose satellite count and shell
        layout come from the registry; `num_satellites` is then ignored.

    `ground` selects a named ground-station network
    (`repro_torch.core.connectivity.GROUND_NETWORKS`: "dense12", "mid4",
    "sparse1") for either mode; "" keeps the spec's default. `days` sets
    the propagated horizon (96 15-minute windows per day).
    """
    num_satellites: int = 40
    days: float = 3.0
    spec_overrides: Dict = field(default_factory=dict)  # ConstellationSpec
    preset: str = ""                   # CONSTELLATIONS registry key
    ground: str = ""                   # GROUND_NETWORKS key ("" = default)

    def build_spec(self):
        """Resolve to the `ConstellationSpec` alone (no propagation)."""
        ground = self.ground or None
        if self.preset:
            return CN.constellation_preset(self.preset, ground=ground,
                                           **self.spec_overrides)
        return CN.resolve_spec(
            CN.ConstellationSpec(num_satellites=self.num_satellites),
            ground, self.spec_overrides)

    def build(self):
        """Resolve to (ConstellationSpec, connectivity matrix C)."""
        spec = self.build_spec()
        return spec, CN.connectivity_sets(spec, days=self.days)


@dataclass
class DatasetConfig:
    """Synthetic-fMoW knobs (see repro_torch.data.fmow.FmowSpec)."""
    num_train: int = 4000
    num_val: int = 1000
    noise: float = 0.9
    image_size: int = 16
    feature_dim: int = 32
    seed: int = 1234

    def to_spec(self) -> FmowSpec:
        return FmowSpec(num_train=self.num_train, num_val=self.num_val,
                        noise=self.noise, image_size=self.image_size,
                        feature_dim=self.feature_dim, seed=self.seed)


@dataclass
class PartitionConfig:
    kind: str = "iid"                      # registry key
    params: Dict = field(default_factory=dict)
    seed: Optional[int] = None             # None -> experiment seed


@dataclass
class AdapterConfig:
    kind: str = "mlp"                      # registry key
    params: Dict = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    kind: str = "fedbuff"                  # registry key
    params: Dict = field(default_factory=dict)
    # FedSpace phase-1 knobs; FedSpace comes with a later slice
    setup: Dict = field(default_factory=dict)


@dataclass
class LinkConfig:
    """Satellite-to-GS link model options: uplink compression plus the
    capacity-constrained link budget (rates, model size, per-station
    concurrent-contact capacity), with the reference's fields and
    validation. Every field uses 0 as its "unconstrained" sentinel; the
    default is the geometry-only model — a contact window is a free,
    instantaneous transfer — which is all this slice of the port runs.
    Anything else raises in `Federation.from_experiment`."""
    uplink_topk: float = 0.0      # >0: top-k+int8 compressed uplink
    uplink_int8: bool = False     # dense int8 uplink (when no top-k)
    uplink_mbps: float = 0.0      # sat->GS rate; 0 = unconstrained
    downlink_mbps: float = 0.0    # GS->sat rate; 0 = unconstrained
    model_mb: float = 0.0         # model transfer size; 0 = instantaneous
    gs_capacity: int = 0          # concurrent contacts/station; 0 = no cap

    def __post_init__(self):
        for name in ("uplink_topk", "uplink_mbps", "downlink_mbps",
                     "model_mb", "gs_capacity"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"LinkConfig.{name} must be >= 0, got {v}")
        if self.uplink_topk > 1:
            raise ValueError(f"LinkConfig.uplink_topk must be in [0, 1], "
                             f"got {self.uplink_topk}")

    @property
    def constrained(self) -> bool:
        """True when any field makes links non-instantaneous or contended
        — i.e. the experiment needs a resolved link budget."""
        return (self.gs_capacity > 0
                or (self.model_mb > 0
                    and (self.uplink_mbps > 0 or self.downlink_mbps > 0)))


# --------------------------------------------------------------------------
# the experiment spec


@dataclass
class FLExperiment:
    """One experiment, as data: constellation x dataset x partition x
    adapter x scheduler x training/link options, every component selected
    by registry name. Build and run it with
    `Federation.from_experiment(exp).run()`. `seed` is the experiment-wide
    default that unset partition/train seeds fall back to. `isl` and
    `faults` mirror the reference's fields; anything but None raises until
    the port has those layers."""
    name: str = ""
    constellation: ConstellationConfig = field(
        default_factory=ConstellationConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    train: EngineConfig = field(default_factory=EngineConfig)
    link: LinkConfig = field(default_factory=LinkConfig)
    isl: Optional[object] = None
    faults: Optional[object] = None
    seed: int = 0


def _later(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the {slice_} slice of the port")


def _check_supported(exp: FLExperiment) -> None:
    """Raise for every part of `exp` this slice of the port cannot run."""
    if exp.link.constrained:
        raise _later("a constrained LinkConfig (link budgets)",
                     "link-budget")
    train = exp.train
    topk = train.uplink_topk if train.uplink_topk is not None \
        else exp.link.uplink_topk
    int8 = train.uplink_int8 if train.uplink_int8 is not None \
        else exp.link.uplink_int8
    if topk or int8:
        raise _later("uplink compression (uplink_topk / uplink_int8)",
                     "compression")
    if exp.isl is not None:
        raise _later("FLExperiment.isl (inter-satellite links)", "ISL")
    if exp.faults is not None:
        raise _later("FLExperiment.faults (fault injection)", "faults")


# --------------------------------------------------------------------------
# built-in partitioners (registry signature: f(data, K, spec, *, days,
# seed, **params))


@register_partition("iid")
def _iid_partition(data, K, spec, *, days, seed, **params):
    return iid_partition(data.spec.num_train, K, seed)


@register_partition("noniid")
def _noniid_partition(data, K, spec, *, days, seed, **params):
    return noniid_partition(data.train_zones, K, spec, days=days,
                            seed=seed, **params)


# --------------------------------------------------------------------------
# the builder


class Federation:
    """A fully wired world on one device: constellation, connectivity,
    data, adapter, scheduler — ready to produce `SimulationEngine`s."""

    def __init__(self, *, experiment: FLExperiment, spec, C: np.ndarray,
                 data, adapter, device, scheduler=None):
        self.experiment = experiment
        self.spec = spec
        self.C = C
        self.data = data
        self.adapter = adapter
        self.device = resolve_device(device)
        self.scheduler = scheduler

    # -- construction -------------------------------------------------------

    @classmethod
    def from_experiment(cls, exp: FLExperiment, *,
                        device=None) -> "Federation":
        """Wire a world from an `FLExperiment` on `device`: resolve the
        constellation (preset or ad hoc) to connectivity, build dataset/
        partition/clients/adapter from their registries, then the
        scheduler. `device=None` means "cuda" and raises when no CUDA
        device is present; pass "cpu" to build on the CPU."""
        device = resolve_device(device)
        _check_supported(exp)
        spec, C = exp.constellation.build()
        data = SyntheticFmow(exp.dataset.to_spec())
        pseed = exp.partition.seed if exp.partition.seed is not None \
            else exp.seed
        parts = PARTITIONS.build(exp.partition.kind, data,
                                 spec.num_satellites, spec,
                                 days=exp.constellation.days, seed=pseed,
                                 **exp.partition.params)
        adapter = ADAPTERS.build(exp.adapter.kind, data,
                                 make_clients(parts), device=device,
                                 **exp.adapter.params)
        fed = cls(experiment=exp, spec=spec, C=C, data=data,
                  adapter=adapter, device=device)
        fed.scheduler = fed._build_scheduler(exp)
        return fed

    def _build_scheduler(self, exp: FLExperiment):
        cfg = exp.scheduler
        if cfg.kind == "fedspace":
            raise _later("the FedSpace scheduler", "FedSpace-scheduling")
        return SCHEDULERS.build(cfg.kind, **cfg.params)

    def connectivity_summary(self, *, windows_per_day: int = 96) -> dict:
        """Scalar Fig.-2 connectivity statistics for this world's C
        (per-window set sizes and per-satellite contacts/day; see
        `repro_torch.core.connectivity.connectivity_stats`), without the
        per-window/per-satellite arrays so the result is
        JSON-serializable."""
        stats = CN.connectivity_stats(self.C, windows_per_day)
        return {k: v for k, v in stats.items()
                if k not in ("sizes", "contacts_per_day")}

    def with_scheduler(self, scheduler: Union[str, SchedulerConfig],
                       **params) -> "Federation":
        """Same world, different aggregation policy — for scheduler
        comparisons without rebuilding constellation/data."""
        cfg = (SchedulerConfig(kind=scheduler, params=params)
               if isinstance(scheduler, str) else scheduler)
        exp = dataclasses.replace(self.experiment, scheduler=cfg)
        fed = Federation(experiment=exp, spec=self.spec, C=self.C,
                         data=self.data, adapter=self.adapter,
                         device=self.device)
        fed.scheduler = fed._build_scheduler(exp)
        return fed

    # -- running ------------------------------------------------------------

    def engine(self, *, callbacks: Sequence = (), init_params=None,
               device=None, mesh=None) -> SimulationEngine:
        """Build a ready-to-run `SimulationEngine` for this world
        (optionally with callbacks / a custom initial model). `device=None`
        means "cuda" and raises when no CUDA device is present; a device
        other than the world's raises, since the adapter's data lives
        there. `mesh` is the reference's satellite-axis sharding; anything
        but None raises until the port has it."""
        # explicitly-set train fields win; unset (None) ones fall back to
        # the experiment-wide seed / LinkConfig compression settings
        exp = self.experiment
        cfg = exp.train
        seed = cfg.seed if cfg.seed is not None else exp.seed
        topk = cfg.uplink_topk if cfg.uplink_topk is not None \
            else exp.link.uplink_topk
        int8 = cfg.uplink_int8 if cfg.uplink_int8 is not None \
            else exp.link.uplink_int8
        cfg = dataclasses.replace(cfg, seed=seed, uplink_topk=topk,
                                  uplink_int8=int8)
        return SimulationEngine(self.C, self.adapter, self.scheduler, cfg,
                                callbacks=callbacks, init_params=init_params,
                                device=device, mesh=mesh)

    def run(self, *, callbacks: Sequence = (),
            init_params=None) -> SimResult:
        """Build the engine on the world's device and execute the run;
        returns its SimResult."""
        return self.engine(callbacks=callbacks, init_params=init_params,
                           device=self.device).run()
