"""The public surface of `repro_torch.fl` against `repro.fl`: the same 27
exported names, each of which resolves to the port's object (none is left
unported: `UNPORTED` is empty), and `FLExperiment.describe()` equal to the
reference's for the quickstart experiment of examples/quickstart.py."""
import pytest

import repro.fl as R
import repro.fl.api as RA
import repro_torch.fl as T
import repro_torch.fl.api as TA
from repro.fl.engine import EngineConfig as REC
from repro_torch.fl.engine import EngineConfig as TEC

UNPORTED = set()


def test_export_lists_are_equal():
    assert T.__all__ == R.__all__
    assert len(T.__all__) == 27
    assert set(T.__all__) <= set(dir(T))


@pytest.mark.parametrize("name", R.__all__)
def test_each_name_resolves_or_names_its_slice(name):
    if name in UNPORTED:
        with pytest.raises(NotImplementedError, match=r"slice .*A\.10"):
            getattr(T, name)
        return
    obj, ref = getattr(T, name), getattr(R, name)
    module = getattr(obj, "__module__", None)
    if module is None:              # a constant, or a registry instance
        assert obj == ref if name == "T0_MINUTES" else obj is not ref
    else:                           # classes, functions
        assert module.startswith("repro_torch."), (name, module)


def test_the_documented_import_works():
    from repro_torch.fl import (DenseNetFmowAdapter, FLExperiment,
                                Federation)
    from repro_torch.fl.adapters import DenseNetFmowAdapter as D
    assert DenseNetFmowAdapter is D
    assert FLExperiment is TA.FLExperiment and Federation is TA.Federation
    with pytest.raises(AttributeError):
        T.no_such_name


def _quickstart(api, engine_config):
    return api.FLExperiment(
        name="quickstart",
        constellation=api.ConstellationConfig(num_satellites=40, days=3.0),
        dataset=api.DatasetConfig(num_train=4000, num_val=1000, noise=2.2),
        partition=api.PartitionConfig(kind="noniid"),
        adapter=api.AdapterConfig(kind="mlp", params={"hidden": 48}),
        scheduler=api.SchedulerConfig(kind="fedbuff", params={"M": 20}),
        train=engine_config(local_steps=16, client_lr=1.0, eval_every=12,
                            target_acc=0.35, max_windows=288))


def test_describe_equals_the_reference():
    got = _quickstart(TA, TEC).describe()
    assert got == _quickstart(RA, REC).describe()
    assert got["adapter"] == {"kind": "mlp", "params": {"hidden": 48}}
    assert got["train"]["local_steps"] == 16 and got["isl"] is None
