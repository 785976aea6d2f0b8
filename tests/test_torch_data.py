"""The port's numpy copies of the geometry and data layers
(`repro_torch.core.connectivity`, `repro_torch.data`) against the JAX
package's: the same specs must give the same arrays, bit for bit, so both
packages train on one world."""
import numpy as np
import pytest

from repro.core import connectivity as RCN
from repro.data import fmow as RF
from repro.data import partition as RP
from repro.data.pipeline import make_clients as r_clients
from repro_torch.core import connectivity as TCN
from repro_torch.data import fmow as TF
from repro_torch.data import partition as TP
from repro_torch.data.pipeline import make_clients as t_clients
from repro_torch.fl import registry as TR
from repro.fl import registry as RR


@pytest.mark.parametrize("preset", ["flock191", "starlink40",
                                    "starlink120"])
@pytest.mark.parametrize("ground", [None, "mid4", "sparse1"])
def test_preset_connectivity_bit_equal(preset, ground):
    rspec = RCN.constellation_preset(preset, ground=ground)
    tspec = TCN.constellation_preset(preset, ground=ground)
    np.testing.assert_array_equal(TCN.connectivity_sets(tspec, days=0.25),
                                  RCN.connectivity_sets(rspec, days=0.25))


def test_spec_resolution_matches():
    base = TCN.ConstellationSpec(num_satellites=12)
    got = TCN.resolve_spec(base, "mid4", {"min_elevation_deg": 30.0})
    ref = RCN.resolve_spec(RCN.ConstellationSpec(num_satellites=12), "mid4",
                           {"min_elevation_deg": 30.0})
    assert got.ground_stations == ref.ground_stations
    assert got.min_elevation_deg == ref.min_elevation_deg == 30.0
    with pytest.raises(KeyError, match="unknown ground network"):
        TCN.resolve_spec(base, "nowhere")


def test_port_registries_are_separate():
    assert TR.CONSTELLATIONS is not RR.CONSTELLATIONS
    assert TR.CONSTELLATIONS.names() == RR.CONSTELLATIONS.names()
    with pytest.raises(KeyError, match="registered constellations"):
        TCN.constellation_preset("no-such-preset")


@pytest.mark.parametrize("noise", [0.9, 2.2])
def test_dataset_bit_equal(noise):
    kw = dict(num_train=500, num_val=120, noise=noise)
    ref, port = RF.SyntheticFmow(RF.FmowSpec(**kw)), \
        TF.SyntheticFmow(TF.FmowSpec(**kw))
    for name in ("train_zones", "train_labels", "val_zones", "val_labels"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    idx = np.arange(500)
    np.testing.assert_array_equal(port.features(idx, "train"),
                                  ref.features(idx, "train"))
    np.testing.assert_array_equal(port.features(idx[:120], "val"),
                                  ref.features(idx[:120], "val"))
    np.testing.assert_array_equal(port.images(idx[:3], "train"),
                                  ref.images(idx[:3], "train"))


@pytest.mark.parametrize("kind", ["iid", "noniid"])
def test_partitions_and_client_batches_equal(kind):
    K = 12
    ref_data = RF.SyntheticFmow(RF.FmowSpec(num_train=400, num_val=50))
    if kind == "iid":
        rparts = RP.iid_partition(400, K, seed=2)
        tparts = TP.iid_partition(400, K, seed=2)
    else:
        rparts = RP.noniid_partition(ref_data.train_zones, K,
                                     RCN.ConstellationSpec(num_satellites=K),
                                     days=0.5, seed=2)
        tparts = TP.noniid_partition(ref_data.train_zones, K,
                                     TCN.ConstellationSpec(num_satellites=K),
                                     days=0.5, seed=2)
    assert len(tparts) == len(rparts) == K
    for a, b in zip(tparts, rparts):
        np.testing.assert_array_equal(a, b)
    for rc, tc in zip(r_clients(rparts), t_clients(tparts)):
        np.testing.assert_array_equal(tc.batches(5, 16, 3),
                                      rc.batches(5, 16, 3))
