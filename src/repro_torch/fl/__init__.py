"""Public surface of `repro_torch.fl`, the federated-learning layer of the
port: registries, adapters, client training, the per-window engine,
callbacks, `run_simulation` and the declarative API, under the
reference's 27 names.

Attribute access is lazy (PEP 562), as in `repro.fl`: the lower
`repro_torch.core` layer imports `repro_torch.fl.registry`, and must not
drag in the adapter and engine modules, which import `repro_torch.core`.
"""
from __future__ import annotations

import importlib

_LAZY = {
    # adapters / client
    "DenseNetFmowAdapter": "repro_torch.fl.adapters",
    "MlpFmowAdapter": "repro_torch.fl.adapters",
    "make_client_update": "repro_torch.fl.client",
    # engine + shim
    "EngineConfig": "repro_torch.fl.engine",
    "SimResult": "repro_torch.fl.engine",
    "SimulationEngine": "repro_torch.fl.engine",
    "T0_MINUTES": "repro_torch.fl.engine",
    "run_simulation": "repro_torch.fl.simulation",
    # declarative experiment layer
    "AdapterConfig": "repro_torch.fl.api",
    "ConstellationConfig": "repro_torch.fl.api",
    "DatasetConfig": "repro_torch.fl.api",
    "FLExperiment": "repro_torch.fl.api",
    "Federation": "repro_torch.fl.api",
    "LinkConfig": "repro_torch.fl.api",
    "PartitionConfig": "repro_torch.fl.api",
    "SchedulerConfig": "repro_torch.fl.api",
    # callbacks
    "Callback": "repro_torch.fl.callbacks",
    "CheckpointCallback": "repro_torch.fl.callbacks",
    "EarlyStopCallback": "repro_torch.fl.callbacks",
    "JsonlMetricsCallback": "repro_torch.fl.callbacks",
    "ProgressCallback": "repro_torch.fl.callbacks",
    # registries
    "ADAPTERS": "repro_torch.fl.registry",
    "PARTITIONS": "repro_torch.fl.registry",
    "SCHEDULERS": "repro_torch.fl.registry",
    "register_adapter": "repro_torch.fl.registry",
    "register_partition": "repro_torch.fl.registry",
    "register_scheduler": "repro_torch.fl.registry",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.fl' has no attribute {name!r}") from None
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
