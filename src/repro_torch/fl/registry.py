"""String-keyed component registries for the PyTorch FL experiment layer.

Every pluggable piece of the federation — aggregation schedulers, model
adapters, dataset partitioners, constellation presets — is registered by
name so experiments can be declared as data (`FLExperiment`) instead of
hand-wired Python:

    from repro_torch.fl.registry import register_scheduler

    @register_scheduler("my-policy")
    class MyScheduler(Scheduler):
        ...

These registries are the port's own instances, separate from the JAX
package's: `Registry.register` is last-wins, so a shared registry would let
the port's "mlp" or "fedbuff" silently replace the reference's entries.

This module is intentionally dependency-free (no torch / numpy imports) so
the lowest layers can register into it without import cycles.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional


class Registry:
    """A named mapping from string keys to factories (classes or callables).

    Lookups raise a `KeyError` that lists what IS registered — a typo in a
    config should cost seconds, not a stack-trace safari.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str,
                 obj: Optional[Callable[..., Any]] = None):
        """Register `obj` under `name`; usable as a decorator.

        Re-registering an existing name overwrites it (last wins) so tests
        and notebooks can iterate on a component without restarting.
        """
        def _do(target: Callable[..., Any]) -> Callable[..., Any]:
            self._entries[name] = target
            return target

        return _do if obj is None else _do(obj)

    # -- lookup -------------------------------------------------------------

    def get(self, name: str) -> Callable[..., Any]:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(repr(n) for n in self.names()) or "<none>"
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered {self.kind}s: "
                f"{known}") from None

    def build(self, name: str, *args, **kwargs) -> Any:
        """Instantiate the registered factory: `registry.build(name, ...)`"""
        return self.get(name)(*args, **kwargs)

    def names(self) -> List[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {self.names()})"


SCHEDULERS = Registry("scheduler")
ADAPTERS = Registry("adapter")
PARTITIONS = Registry("partition")
CONSTELLATIONS = Registry("constellation")


def register_scheduler(name: str, obj=None):
    """Class/function decorator: register an aggregation-policy factory."""
    return SCHEDULERS.register(name, obj)


def register_constellation(name: str, obj=None):
    """Function decorator: register a constellation-preset factory
    `f(*, ground=None, **overrides) -> ConstellationSpec` (see
    `repro_torch.core.connectivity` for the built-in scenario suite)."""
    return CONSTELLATIONS.register(name, obj)


def register_adapter(name: str, obj=None):
    """Class/function decorator: register a model-adapter factory
    `f(data, clients, *, device, **params) -> adapter`."""
    return ADAPTERS.register(name, obj)


def register_partition(name: str, obj=None):
    """Function decorator: register a partitioner
    `f(data, K, spec, *, days, seed, **params) -> List[np.ndarray]`."""
    return PARTITIONS.register(name, obj)
