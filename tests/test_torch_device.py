"""Where the port runs: its entry points default to the card and raise
when there is none (nothing carries on on the CPU unless the caller passes
device="cpu"), and a CUDA tensor reaches the kernel or raises. The
`gpu`-marked test holds the CUDA kernel against its plain version on the
card; it skips where there is no CUDA device (decided inside the test)."""
import numpy as np
import pytest
import torch

import repro_torch.fl.api as TA
from repro_torch.core import connectivity as TCN
from repro_torch.core.scheduler import FedBuffScheduler
from repro_torch.data.fmow import FmowSpec, SyntheticFmow
from repro_torch.data.partition import iid_partition
from repro_torch.data.pipeline import make_clients
from repro_torch.fl.adapters import MlpFmowAdapter
from repro_torch.fl.engine import EngineConfig, SimulationEngine
from repro_torch.kernels import launch_counts
from repro_torch.kernels.agg.kernel import weighted_aggregate
from repro_torch.kernels.agg.ref import weighted_aggregate_ref


def _exp():
    return TA.FLExperiment(
        constellation=TA.ConstellationConfig(num_satellites=8, days=0.25),
        dataset=TA.DatasetConfig(num_train=200, num_val=50),
        scheduler=TA.SchedulerConfig(kind="fedbuff", params={"M": 2}),
        train=EngineConfig(local_steps=2, eval_every=4))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_federation_defaults_to_the_card_and_raises_without_one():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.Federation.from_experiment(_exp())
    fed = TA.Federation.from_experiment(_exp(), device="cpu")
    assert fed.device.type == "cpu" and fed.adapter.device.type == "cpu"
    # a world built on the CPU still builds engines on the card by default
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fed.engine(**kw)
    assert fed.engine(device="cpu").device.type == "cpu"


def test_simulation_engine_defaults_to_the_card_and_raises_without_one():
    _no_card()
    data = SyntheticFmow(FmowSpec(num_train=100, num_val=20))
    adapter = MlpFmowAdapter(data, make_clients(iid_partition(100, 4)),
                             hidden=8, device="cpu")
    C = TCN.connectivity_sets(TCN.ConstellationSpec(num_satellites=4),
                              days=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationEngine(C, adapter, FedBuffScheduler(M=2))
    eng = SimulationEngine(C, adapter, FedBuffScheduler(M=2), device="cpu")
    assert eng.run().windows_run == C.shape[0]


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the wrapper down
    its kernel path on a machine that has no card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_agg_wrapper_sends_cuda_tensors_to_the_kernel_or_raises():
    _no_card()
    p, upd, w = torch.zeros(8), torch.ones(3, 8), torch.ones(3) / 3
    fake = [torch.Tensor._make_subclass(_CudaLabelled, t)
            for t in (p, upd, w)]
    before = launch_counts["weighted_aggregate"]
    with pytest.raises(RuntimeError, match="CUDA device"):
        weighted_aggregate(*fake)
    assert launch_counts["weighted_aggregate"] == before
    with pytest.raises(ValueError, match="runs on CUDA"):
        weighted_aggregate(p.to("meta"), upd.to("meta"), w.to("meta"))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(0)
    # quickstart leaf sizes (1536, 48, 2976, 62), a size that is not a
    # multiple of 4 and a misaligned view: both 1- and 4-wide paths
    for m, n, pdt, udt, offset in [
            (20, 1536, torch.float32, torch.float32, 0),
            (40, 62, torch.float32, torch.float32, 0),
            (7, 5001, torch.float32, torch.bfloat16, 0),
            (5, 4096, torch.bfloat16, torch.bfloat16, 0),
            (3, 4096, torch.float32, torch.float32, 1)]:
        # an offset of one element leaves the updates unaligned
        upd = torch.randn(m * n + offset, generator=g, device="cuda")[
            offset:].view(m, n).to(udt)
        p = torch.randn(n, generator=g, device="cuda").to(pdt)
        w = torch.rand(m, generator=g, device="cuda")
        w = w / w.sum()
        before = launch_counts["weighted_aggregate"]
        out = weighted_aggregate(p, upd, w)
        torch.cuda.synchronize()
        assert launch_counts["weighted_aggregate"] == before + 1
        assert out.dtype == pdt and out.device.type == "cuda"
        ref = weighted_aggregate_ref(p, upd, w)
        # float32: the same products summed in another order; bf16 output:
        # one rounding of the result
        tol = 1e-2 if pdt == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   rtol=tol, atol=tol)
