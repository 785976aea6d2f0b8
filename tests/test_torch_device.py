"""Where the port runs: its entry points default to the card and raise
when there is none (nothing carries on on the CPU unless the caller passes
device="cpu"), and a CUDA tensor reaches the kernel or raises. The
`gpu`-marked tests hold each CUDA kernel against its plain version on the
card; they skip where there is no CUDA device (decided inside the test)."""
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
from repro_torch.core import staleness as TS
from repro_torch.kernels import launch_counts
from repro_torch.kernels.agg.kernel import weighted_aggregate
from repro_torch.kernels.agg.ref import weighted_aggregate_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_fwd_ref


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


def test_protocol_state_defaults_to_the_card_and_raises_without_one():
    _no_card()
    for make in (TS.init_state, TS.bootstrap_state):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(4)
        assert make(4, device="cpu").version.device.type == "cpu"


def _fake_cuda(*tensors):
    return [torch.Tensor._make_subclass(_CudaLabelled, t) for t in tensors]


def test_rmsnorm_and_attention_wrappers_send_cuda_tensors_to_the_kernels():
    """Every new entry point, and the autograd functions over them, takes
    a CUDA tensor to its kernel (which cannot be built here) and raises;
    none falls back to its plain version."""
    _no_card()
    x, s = torch.ones(2, 8, 16), torch.ones(16)
    y, rstd = rms_kernel.rmsnorm(x, s)
    q, k = torch.ones(1, 4, 8, 8), torch.ones(1, 2, 8, 8)
    o, lse = flash_kernel.flash_attention(q, k, k)
    before = dict(launch_counts)
    calls = [
        lambda: rms_kernel.rmsnorm(*_fake_cuda(x, s)),
        lambda: rms_kernel.rmsnorm_bwd(*_fake_cuda(x, s, rstd, x)),
        lambda: rms_ops.rmsnorm(*_fake_cuda(x, s)),
        lambda: flash_kernel.flash_attention(*_fake_cuda(q, k, k)),
        lambda: flash_kernel.flash_attention_bwd(
            *_fake_cuda(q, k, k, o, lse, o)),
        lambda: flash_ops.flash_attention(*_fake_cuda(q, k, k)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    assert dict(launch_counts) == before
    with pytest.raises(ValueError, match="runs on CUDA"):
        rms_kernel.rmsnorm(x.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="runs on CUDA"):
        flash_kernel.flash_attention(q.to("meta"), k.to("meta"),
                                     k.to("meta"))


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


def _card_tol(dtype, grad=False):
    """float32: the same arithmetic in another order (1e-4 for gradient
    sums over many rows); bfloat16: one rounding of the same float32
    result that may go the other way, at most 2**-7 of the value, under
    rtol 1e-2 (atol 1e-2 for values near 0)."""
    if dtype == torch.bfloat16:
        return dict(rtol=1e-2, atol=1e-2)
    return dict(rtol=1e-4, atol=1e-4) if grad else dict(rtol=2e-5,
                                                        atol=2e-5)


@pytest.mark.gpu
def test_rmsnorm_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(0)
    # the payload's training call, a sweep shape, and bfloat16
    for (G, R, D), dt in [((20, 256, 32), torch.float32),
                          ((1, 37, 512), torch.float32),
                          ((1, 37, 512), torch.bfloat16)]:
        x = torch.randn(G, R, D, generator=g, device="cuda").to(dt)
        s = (1 + torch.randn(G, D, generator=g, device="cuda")).to(dt)
        dy = torch.randn(G, R, D, generator=g, device="cuda").to(dt)
        before = dict(launch_counts)
        y, rstd = rms_kernel.rmsnorm(x, s)
        dx, ds = rms_kernel.rmsnorm_bwd(x, s, rstd, dy)
        torch.cuda.synchronize()
        assert launch_counts["rmsnorm"] == before.get("rmsnorm", 0) + 1
        assert launch_counts["rmsnorm_bwd"] == \
            before.get("rmsnorm_bwd", 0) + 1
        # the plain backward starts from the plain forward's own rstd, so
        # a wrong rstd from the kernel shows in both directions
        ry, rrstd = rmsnorm_fwd_ref(x, s)
        rdx, rds = rmsnorm_bwd_ref(x, s, rrstd, dy)
        torch.testing.assert_close(y.float(), ry.float(), **_card_tol(dt))
        torch.testing.assert_close(rstd, rrstd, **_card_tol(torch.float32))
        torch.testing.assert_close(dx.float(), rdx.float(),
                                   **_card_tol(dt, True))
        torch.testing.assert_close(ds.float(), rds.float(),
                                   **_card_tol(dt, True))


@pytest.mark.gpu
def test_flash_attention_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(0)
    # the payload's training call, a GQA x window sweep shape, bfloat16
    for (B, H, K, S, hd, causal, window), dt in [
            ((640, 4, 2, 8, 8, True, 0), torch.float32),
            ((2, 8, 1, 128, 64, True, 32), torch.float32),
            ((1, 2, 2, 100, 128, False, 0), torch.bfloat16)]:
        q, do = (torch.randn(B, H, S, hd, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, K, S, hd, generator=g, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window)
        before = dict(launch_counts)
        o, lse = flash_kernel.flash_attention(q, k, v, **kw)
        grads = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert launch_counts["flash_attention"] == \
            before.get("flash_attention", 0) + 1
        assert launch_counts["flash_attention_bwd"] == \
            before.get("flash_attention_bwd", 0) + 1
        # the plain backward starts from the plain forward's own o and
        # log-sum-exp, so a wrong lse from the kernel shows in both
        # directions (no row of these shapes is fully masked)
        ro, rlse = attention_fwd_ref(q, k, v, **kw)
        torch.testing.assert_close(o.float(), ro.float(), **_card_tol(dt))
        torch.testing.assert_close(lse, rlse, **_card_tol(torch.float32))
        for got, ref in zip(grads, attention_bwd_ref(q, k, v, ro, rlse, do,
                                                     **kw)):
            torch.testing.assert_close(got.float(), ref.float(),
                                       **_card_tol(dt, True))


@pytest.mark.gpu
def test_autograd_functions_match_plain_autograd_on_the_card():
    """The ops' autograd functions (kernels both ways, on the card) against
    autograd of the plain version (on the CPU) at the transformer path's
    shapes: per-satellite scale rows for RMSNorm, the (B, S, H, hd)
    layout for attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    r = np.random.default_rng(0)

    def grads(fn, arrays, cot, device):
        xs = [torch.tensor(a, device=device, requires_grad=True)
              for a in arrays]
        out = fn(*xs)
        return [out] + list(torch.autograd.grad(
            out, xs, torch.tensor(cot, device=device)))

    x = r.standard_normal((20, 32, 8, 32)).astype(np.float32)
    s = (1 + 0.5 * r.standard_normal((20, 32))).astype(np.float32)
    q = r.standard_normal((64, 8, 4, 8)).astype(np.float32)
    k, v = (r.standard_normal((64, 8, 2, 8)).astype(np.float32)
            for _ in range(2))
    for fn, arrays, cot in (
            (lambda a, b: rms_ops.rmsnorm(a, b, 1e-6), (x, s),
             r.standard_normal(x.shape).astype(np.float32)),
            (lambda a, b, c: flash_ops.flash_attention_bshd(a, b, c),
             (q, k, v), r.standard_normal(q.shape).astype(np.float32))):
        before = sum(launch_counts.values())
        card = grads(fn, arrays, cot, "cuda")
        assert sum(launch_counts.values()) == before + 2   # fwd and bwd
        for got, ref in zip(card, grads(fn, arrays, cot, "cpu")):
            assert got.shape == ref.shape
            torch.testing.assert_close(got.cpu(), ref,
                                       **_card_tol(torch.float32, True))
