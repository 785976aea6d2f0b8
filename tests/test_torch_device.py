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
from repro_torch.kernels.agg import kernel as agg_kernel
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


# (M, R, N, element offset of the updates, params dtype, updates dtype):
# N on both sides of the ring's cut-off, with tails (N modulo the tile)
# and unaligned leading columns, the main paths' flat models, N = 62 (all
# edge columns on the ring), bfloat16 updates into float32 params and
# bfloat16 both, and the paper's size (M = 191, DenseNet-161) in both
# update types
_F32, _BF16 = torch.float32, torch.bfloat16
AGG_DESIGN_CASES = [
    (20, 24, 62, 0, _F32, _F32), (20, 20, 4622, 0, _F32, _F32),
    (20, 23, 4621, 1, _F32, _F32), (36, 40, 20768, 0, _F32, _F32),
    (20, 26, agg_kernel.RING_MIN_N - 1, 1, _F32, _F32),
    (20, 26, agg_kernel.RING_MIN_N + 4621, 3, _F32, _BF16),
    (7, 9, agg_kernel.RING_MIN_N + 8191, 5, _BF16, _BF16),
    (191, 191, 26_608_958, 0, _F32, _F32),
    (191, 191, 26_608_958, 0, _F32, _BF16)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,r,n,offset,pdt,udt", AGG_DESIGN_CASES)
def test_agg_designs_bit_equal_on_the_card(m, r, n, offset, pdt, udt):
    """The register design and the ring (default and other stages and
    tiles) give the same bits on permuted rows of a wider buffer, each
    within the float32 tolerance of the plain version (one rounding in
    bfloat16 outputs), two calls alike, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(n % 1000 + m)
    ld = -(-(n + offset) // 64) * 64
    buf = torch.randn(r, ld, generator=g, device="cuda").to(udt)
    updates = buf[:, offset:offset + n]
    rows = torch.randperm(r, generator=g, device="cuda")[:m].int()
    p = torch.randn(n, generator=g, device="cuda").to(pdt)
    w = torch.rand(m, generator=g, device="cuda")
    w /= w.sum()
    outs = []
    for kw in (dict(design="register"), dict(design="ring"),
               dict(design="ring", stages=2, tile_bytes=32768),
               dict(design="ring")):
        before = launch_counts["weighted_aggregate"]
        outs.append(weighted_aggregate(p, updates, w, rows, **kw))
        assert launch_counts["weighted_aggregate"] == before + 1
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert outs[0].dtype == pdt and outs[0].shape == (n,)
    ref = weighted_aggregate_ref(p, updates, w, rows)
    del buf, updates
    torch.testing.assert_close(outs[0].float(), ref.float(),
                               **_card_tol(pdt))


@pytest.mark.gpu
def test_agg_ring_repeats_bitwise_over_stages_and_tiles():
    """Every ring of 2-12 stages of 8, 16 and 32 KB a row, three calls
    each, gives the register design's bits at the paper's size with
    bfloat16 updates (where a ring whose stages were refilled before
    their reads had finished gave wrong columns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(19)
    m, n = 191, 26_608_958
    buf = torch.randn(m + 3, n + 2, generator=g, device="cuda").to(_BF16)
    updates = buf[:, :n]
    rows = torch.randperm(m + 3, generator=g, device="cuda")[:m].int()
    p = torch.randn(n, generator=g, device="cuda")
    w = torch.rand(m, generator=g, device="cuda")
    w /= w.sum()
    want = weighted_aggregate(p, updates, w, rows, design="register")
    for tile in (8192, 16384, 32768):
        for stages in (2, 3, 4, 6, 8, 12):
            if not agg_kernel.ring_fits(stages, tile):
                continue
            for _ in range(3):
                got = weighted_aggregate(p, updates, w, rows, design="ring",
                                         stages=stages, tile_bytes=tile)
                assert torch.equal(got, want), (stages, tile)


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
    # the payload's training call, a sweep shape, bfloat16, and the edges
    # of the kernels' paths: a 72-byte row (the 1-wide path), an x that
    # starts one element into its buffer (unaligned: the 1-wide path), and
    # several groups whose rows are no multiple of a tile
    for (G, R, D), dt, off in [((20, 256, 32), torch.float32, 0),
                               ((1, 37, 512), torch.float32, 0),
                               ((1, 37, 512), torch.bfloat16, 0),
                               ((4, 300, 36), torch.bfloat16, 0),
                               ((2, 100, 256), torch.float32, 1),
                               ((8, 1000, 1024), torch.float32, 0)]:
        x = torch.randn(G * R * D + off, generator=g, device="cuda")[
            off:].view(G, R, D).to(dt)
        assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (off > 0)
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
        # no floating-point atomics: a second call repeats bit for bit
        dx2, ds2 = rms_kernel.rmsnorm_bwd(x, s, rstd, dy)
        assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


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
    # every call, forward and backward, on the counters of every call (the
    # `_short` and `_tc` counters count some of those calls again)
    calls = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
             "flash_attention_bwd")
    for fn, arrays, cot in (
            (lambda a, b: rms_ops.rmsnorm(a, b, 1e-6), (x, s),
             r.standard_normal(x.shape).astype(np.float32)),
            (lambda a, b, c: flash_ops.flash_attention_bshd(a, b, c),
             (q, k, v), r.standard_normal(q.shape).astype(np.float32))):
        before = sum(launch_counts[n] for n in calls)
        card = grads(fn, arrays, cot, "cuda")
        assert sum(launch_counts[n] for n in calls) == before + 2   # fwd, bwd
        for got, ref in zip(card, grads(fn, arrays, cot, "cpu")):
            assert got.shape == ref.shape
            torch.testing.assert_close(got.cpu(), ref,
                                       **_card_tol(torch.float32, True))


# (B, H, K, Sq, Sk, causal, window): the GQA x mask sweep at S = 128, a
# ragged Sq = 100 against Sk = 200, and a window of 2 with Sq > Sk, where
# the last query rows see no key
TC_SHAPES = [(2, h, k, 128, 128, causal, window)
             for h, k in ((4, 4), (4, 2), (8, 1))
             for causal, window in ((True, 0), (True, 32), (False, 0))] + [
    (1, 2, 2, 100, 200, False, 0), (1, 4, 2, 100, 200, True, 0),
    (1, 4, 2, 40, 16, True, 2)]


@pytest.mark.gpu
def test_tensor_core_forward_matches_plain_version_on_the_card():
    """The bfloat16 forward at head dims 64 and 128 takes the tensor-core
    kernel (one launch on either counter) and agrees with the plain
    version: o at the bfloat16 tolerance, lse at the float32 one, rows
    that see no key 0 and -inf in both, a q that is not 16-byte aligned
    (the wrapper copies it) as any other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(3)
    for hd in (64, 128):
        for B, H, K, sq, sk, causal, window in TC_SHAPES:
            # the last shape's q starts one element into its buffer
            off = int(window == 2)
            q = torch.randn(B * H * sq * hd + off, generator=g,
                            device="cuda").bfloat16()[off:].view(
                                B, H, sq, hd)
            k, v = (torch.randn(B, K, sk, hd, generator=g,
                                device="cuda").bfloat16() for _ in range(2))
            kw = dict(causal=causal, window=window)
            assert flash_kernel.route(q.dtype, hd) == "tc"
            before = dict(launch_counts)
            o, lse = flash_kernel.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            for name in ("flash_attention", "flash_attention_tc"):
                assert launch_counts[name] == before.get(name, 0) + 1
            ro, rlse = attention_fwd_ref(q, k, v, **kw)
            torch.testing.assert_close(o.float(), ro.float(),
                                       **_card_tol(torch.bfloat16))
            torch.testing.assert_close(lse, rlse,
                                       **_card_tol(torch.float32))
            if window == 2:
                dead = torch.isneginf(rlse)
                assert dead.any() and torch.equal(torch.isneginf(lse), dead)
                assert not o[dead].any()


@pytest.mark.gpu
def test_odd_head_dims_are_padded_on_the_card():
    """ROADMAP C9 on the card: head dims 12 (float32, padded to 16 on the
    CUDA cores) and 80 (bfloat16, padded to 128 on the tensor cores, and
    float32 on the CUDA cores), forward and backward against the plain
    version at the true head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(4)
    for hd, dt, tc in ((12, torch.float32, False), (80, torch.bfloat16, True),
                       (80, torch.float32, False)):
        q, do = (torch.randn(2, 4, 50, hd, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(2, 2, 50, hd, generator=g, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(causal=True, window=3)
        before = launch_counts["flash_attention_tc"]
        o, lse = flash_kernel.flash_attention(q, k, v, **kw)
        grads = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert launch_counts["flash_attention_tc"] == before + tc
        assert o.shape == q.shape and o.is_contiguous()
        ro, rlse = attention_fwd_ref(q, k, v, **kw)
        torch.testing.assert_close(o.float(), ro.float(), **_card_tol(dt))
        torch.testing.assert_close(lse, rlse, **_card_tol(torch.float32))
        for got, ref, t in zip(grads, attention_bwd_ref(q, k, v, ro, rlse,
                                                        do, **kw), (q, k, v)):
            assert got.shape == t.shape
            torch.testing.assert_close(got.float(), ref.float(),
                                       **_card_tol(dt, True))


@pytest.mark.gpu
def test_rmsnorm_wide_rows_on_the_card():
    """ROADMAP C10 on the card: rows wider than the registers hold (D =
    20,000 float32 and 32,768 bfloat16 on the 16-byte path, 4,100 float32
    one element into its buffer on the 1-wide path) take the row-looping
    kernels and agree with the plain version; two backward calls are
    bit-equal. The first shape is one tile (dscale written directly), the
    others several tiles a group (partial sums, a grid-wide barrier)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(5)
    for (G, R, D), dt, off in (((1, 16, 20_000), torch.float32, 0),
                               ((2, 40, 32_768), torch.bfloat16, 0),
                               ((3, 300, 4_100), torch.float32, 1)):
        x = torch.randn(G * R * D + off, generator=g, device="cuda")[
            off:].view(G, R, D).to(dt)
        vec = rms_kernel.vector_width(D, x.element_size(), x.data_ptr())
        assert rms_kernel.layout(D // vec, vec > 1, 2) == rms_kernel.LOOP
        s = (1 + torch.randn(G, D, generator=g, device="cuda")).to(dt)
        dy = torch.randn(G, R, D, generator=g, device="cuda").to(dt)
        y, rstd = rms_kernel.rmsnorm(x, s)
        dx, ds = rms_kernel.rmsnorm_bwd(x, s, rstd, dy)
        dx2, ds2 = rms_kernel.rmsnorm_bwd(x, s, rstd, dy)
        torch.cuda.synchronize()
        ry, rrstd = rmsnorm_fwd_ref(x, s)
        rdx, rds = rmsnorm_bwd_ref(x, s, rrstd, dy)
        torch.testing.assert_close(y.float(), ry.float(), **_card_tol(dt))
        torch.testing.assert_close(rstd, rrstd, **_card_tol(torch.float32))
        torch.testing.assert_close(dx.float(), rdx.float(),
                                   **_card_tol(dt, True))
        torch.testing.assert_close(ds.float(), rds.float(),
                                   **_card_tol(dt, True))
        assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.gpu
def test_tensor_core_backward_matches_plain_version_on_the_card():
    """The bfloat16 backward at head dims 64 and 128 (and 80, padded to
    128) takes the tensor-core kernels (one call on either counter) and
    agrees with the plain backward fed the plain forward's o and lse, at
    the bfloat16 gradient tolerance, over the GQA x mask sweep, Sq 100 /
    Sk 200, and a window of 2 with Sq > Sk (rows that see no key get
    gradient 0) whose q is not 16-byte aligned (the wrapper copies it);
    two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [(hd, shape) for hd in (64, 128) for shape in TC_SHAPES] + [
        (80, (1, 4, 2, 100, 200, True, 0))]
    for hd, (B, H, K, sq, sk, causal, window) in cases:
        off = int(window == 2)
        q = torch.randn(B * H * sq * hd + off, generator=g,
                        device="cuda").bfloat16()[off:].view(B, H, sq, hd)
        k, v = (torch.randn(B, K, sk, hd, generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        do = torch.randn(B, H, sq, hd, generator=g, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window)
        assert flash_kernel.route(
            q.dtype, flash_kernel.padded_head_dim(hd)) == "tc"
        o, lse = flash_kernel.flash_attention(q, k, v, **kw)
        before = dict(launch_counts)
        grads = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for name in ("flash_attention_bwd", "flash_attention_bwd_tc"):
            assert launch_counts[name] == before.get(name, 0) + 1
        again = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        ro, rlse = attention_fwd_ref(q, k, v, **kw)
        for got, ref, t in zip(grads, attention_bwd_ref(q, k, v, ro, rlse,
                                                        do, **kw), (q, k, v)):
            assert got.shape == t.shape and got.dtype == t.dtype
            torch.testing.assert_close(got.float(), ref.float(),
                                       **_card_tol(torch.bfloat16, True))
        if window == 2:
            dead = torch.isneginf(rlse)
            assert dead.any() and not grads[0][dead].any()


@pytest.mark.gpu
def test_wide_head_dims_on_the_card():
    """ROADMAP C9 above 256 on the card: head dims 257 (float32), 300
    (bfloat16, window 3) and 1,000 (float32), padded to multiples of 256
    for the row-looping CUDA-core kernels, forward and backward against the
    plain version at the true head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(7)
    for hd, dt, window in ((257, torch.float32, 0), (300, torch.bfloat16, 3),
                           (1000, torch.float32, 0)):
        q, do = (torch.randn(1, 4, 40, hd, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(1, 2, 40, hd, generator=g, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(causal=True, window=window)
        width = flash_kernel.padded_head_dim(hd)
        assert width % 256 == 0 and flash_kernel.route(dt, width) == \
            "cuda_core"
        before = dict(launch_counts)
        o, lse = flash_kernel.flash_attention(q, k, v, **kw)
        grads = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert launch_counts["flash_attention"] == \
            before.get("flash_attention", 0) + 1
        assert launch_counts["flash_attention_bwd"] == \
            before.get("flash_attention_bwd", 0) + 1
        assert launch_counts["flash_attention_bwd_tc"] == \
            before.get("flash_attention_bwd_tc", 0)
        ro, rlse = attention_fwd_ref(q, k, v, **kw)
        assert o.shape == q.shape and o.is_contiguous()
        torch.testing.assert_close(o.float(), ro.float(), **_card_tol(dt))
        torch.testing.assert_close(lse, rlse, **_card_tol(torch.float32))
        for got, ref, t in zip(grads, attention_bwd_ref(q, k, v, ro, rlse,
                                                        do, **kw), (q, k, v)):
            assert got.shape == t.shape
            torch.testing.assert_close(got.float(), ref.float(),
                                       **_card_tol(dt, True))


# (B, H, K, Sq, Sk, hd, causal, window) of the short-sequence kernels: the
# transformer path's training and evaluation calls; G = 1, 2, 4, 8 query
# heads a kv head with causal, window 3 and no mask; Sq != Sk both ways; a
# head dim padded from 12 to 16; a window of 3 with Sq > Sk, where the
# query rows from Sk + 2 on see no key; and the wider instantiations,
# padded hd 32, 64, 128 and 256 (48 and 200 padded), each with a mask
SHORT_CASES = [(640, 4, 2, 8, 8, 8, True, 0), (1000, 4, 2, 8, 8, 8, True, 0)] \
    + [(6, 2 * g, 2, 8, 8, 8, causal, window) for g in (1, 2, 4, 8)
       for causal, window in ((True, 0), (True, 3), (False, 0))] + [
    (4, 4, 2, 8, 24, 8, True, 0), (4, 4, 2, 24, 8, 8, False, 0),
    (4, 4, 2, 8, 8, 12, True, 0), (3, 8, 2, 24, 8, 8, True, 3),
    (6, 4, 2, 8, 8, 32, True, 3), (6, 4, 2, 8, 8, 64, True, 0),
    (6, 4, 2, 8, 8, 48, False, 0), (6, 4, 2, 8, 8, 128, True, 0),
    (4, 2, 2, 8, 16, 128, True, 3), (6, 2, 2, 8, 8, 256, True, 0),
    (4, 2, 2, 12, 4, 200, True, 3)]


def _short_inputs(g, B, H, K, sq, sk, hd, dt):
    q, do = (torch.randn(B, H, sq, hd, generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, K, sk, hd, generator=g, device="cuda").to(dt)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.gpu
def test_short_kernels_match_plain_version_on_the_card():
    """Every SHORT_CASES call, in float32 and in bfloat16 (where bfloat16
    is the CUDA cores' route: not at padded hd 64 and 128, the tensor
    cores'), takes the short-sequence kernels (one call on each `_short`
    counter) and agrees
    with the plain version at the card's tolerances, o and lse forward,
    dq, dk and dv backward (the plain backward fed the plain forward's o
    and lse); rows that see no key give o = 0, lse = -inf and zero
    gradients, and nothing is NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        for B, H, K, sq, sk, hd, causal, window in SHORT_CASES:
            width = flash_kernel.padded_head_dim(hd)
            if flash_kernel.route(dt, width) == "tc":
                assert dt == torch.bfloat16 and width in (64, 128)
                continue
            assert flash_kernel.short_fits(H // K, sq, sk, width, dt)
            q, k, v, do = _short_inputs(g, B, H, K, sq, sk, hd, dt)
            kw = dict(causal=causal, window=window)
            before = dict(launch_counts)
            o, lse = flash_kernel.flash_attention(q, k, v, **kw)
            grads = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do,
                                                     **kw)
            torch.cuda.synchronize()
            for name in ("flash_attention", "flash_attention_short",
                         "flash_attention_bwd", "flash_attention_bwd_short"):
                assert launch_counts[name] == before.get(name, 0) + 1
            ro, rlse = attention_fwd_ref(q, k, v, **kw)
            assert o.shape == q.shape and o.dtype == dt
            torch.testing.assert_close(o.float(), ro.float(), **_card_tol(dt))
            torch.testing.assert_close(lse, rlse, **_card_tol(torch.float32))
            for got, ref, t in zip(grads, attention_bwd_ref(
                    q, k, v, ro, rlse, do, **kw), (q, k, v)):
                assert got.shape == t.shape and got.dtype == dt
                assert not got.isnan().any()
                torch.testing.assert_close(got.float(), ref.float(),
                                           **_card_tol(dt, True))
            dead = torch.isneginf(rlse)
            assert torch.equal(torch.isneginf(lse), dead)
            if window and sq > sk:
                assert dead.any() and not o[dead].any()
                assert not grads[0][dead].any()


@pytest.mark.gpu
def test_short_kernels_read_strided_views_bit_equal():
    """The (B, S, H, hd) entry points on strided views of one fused
    projection (and a cotangent viewed from (B, S, H * hd)) give the same
    bits as on the same values made contiguous, forward and backward; o
    comes back contiguous, so that (B, S, H * hd) is a view of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(9)
    for dt in (torch.float32, torch.bfloat16):
        for B, S, H, K, hd, window in ((640, 8, 4, 2, 8, 0),
                                       (5, 32, 4, 2, 16, 3),
                                       (7, 8, 2, 2, 32, 3)):
            assert flash_kernel.short_fits(H // K, S, S, hd, dt)
            fused = torch.randn(B, S, H + 2 * K, hd, generator=g,
                                device="cuda").to(dt)
            q, k, v = (fused[:, :, :H], fused[:, :, H:H + K],
                       fused[:, :, H + K:])
            do = torch.randn(B, S, H * hd, generator=g, device="cuda").to(
                dt).view(B, S, H, hd)
            assert not q.is_contiguous()
            kw = dict(causal=True, window=window)
            before = launch_counts["flash_attention_short"]
            o, lse = flash_kernel.flash_attention_bshd(q, k, v, **kw)
            grads = flash_kernel.flash_attention_bshd_bwd(q, k, v, o, lse,
                                                          do, **kw)
            dense = [t.contiguous() for t in (q, k, v, do)]
            o2, lse2 = flash_kernel.flash_attention_bshd(*dense[:3], **kw)
            grads2 = flash_kernel.flash_attention_bshd_bwd(
                *dense[:3], o2, lse2, dense[3], **kw)
            torch.cuda.synchronize()
            assert launch_counts["flash_attention_short"] == before + 2
            assert o.is_contiguous() and o.shape == (B, S, H, hd)
            assert torch.equal(o, o2) and torch.equal(lse, lse2)
            assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
            ro, rlse = attention_fwd_ref(*(t.transpose(1, 2)
                                           for t in (q, k, v)), **kw)
            torch.testing.assert_close(o.float(), ro.transpose(1, 2).float(),
                                       **_card_tol(dt))


@pytest.mark.gpu
def test_short_backward_repeats_bitwise():
    """No atomics: two backward calls of the short-sequence kernel give the
    same bits, at the path's shape and at G = 4, S = 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(10)
    for B, H, K, S, hd in ((640, 4, 2, 8, 8), (8, 4, 1, 32, 8)):
        for dt in (torch.float32, torch.bfloat16):
            assert flash_kernel.short_fits(H // K, S, S, hd, dt)
            q, k, v, do = _short_inputs(g, B, H, K, S, S, hd, dt)
            o, lse = flash_kernel.flash_attention(q, k, v)
            first = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)
            again = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def _cuda_core_direct(q, k, v, o, lse, do, causal, window, fwd):
    """The CUDA-core kernels that the short ones took over, through their
    C entry points (`_library()[0]` and `[1]`), on an unpadded hd."""
    lib = flash_kernel._library()
    dims = flash_kernel._dims(q, k, causal, window, q.shape[-1])
    if fwd:
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], device=q.device)
        assert lib[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), *dims) == 0
        return o, lse
    grads = [torch.empty_like(t) for t in (q, k, v)]
    delta = torch.empty(q.shape[:3], device=q.device)
    assert lib[1](*(t.data_ptr() for t in (q, k, v, o, lse, do, *grads,
                                          delta)), *dims) == 0
    return grads


@pytest.mark.gpu
def test_each_backward_takes_the_other_forwards_o_and_lse():
    """The short backward fed the CUDA-core forward's o and lse, and the
    CUDA-core backward fed the short forward's, agree with the plain
    backward at the card's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    g = torch.Generator(device="cuda").manual_seed(11)
    for B, H, K, sq, sk, hd, causal, window in (
            (640, 4, 2, 8, 8, 8, True, 0), (4, 8, 1, 24, 8, 8, True, 3)):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = _short_inputs(g, B, H, K, sq, sk, hd, dt)
            kw = dict(causal=causal, window=window)
            ro, rlse = attention_fwd_ref(q, k, v, **kw)
            ref = attention_bwd_ref(q, k, v, ro, rlse, do, **kw)
            o_cc, lse_cc = _cuda_core_direct(q, k, v, None, None, None,
                                             causal, window, fwd=True)
            o_s, lse_s = flash_kernel.flash_attention(q, k, v, **kw)
            for got in (flash_kernel.flash_attention_bwd(q, k, v, o_cc,
                                                         lse_cc, do, **kw),
                        _cuda_core_direct(q, k, v, o_s, lse_s, do, causal,
                                          window, fwd=False)):
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    assert not a.isnan().any()
                    torch.testing.assert_close(a.float(), b.float(),
                                               **_card_tol(dt, True))


# --------------------------------------------------------------------------
# FedSpace scheduling on the card


def _hist_forest(seed=3, s_max=8, n=400):
    """A forest over staleness histograms at status 1.0 (the fixture of
    tests/test_hotpath_parity.py, fitted with the port's own forest): no
    split is on T, so a schedule cannot depend on the float val loss."""
    from repro_torch.core.utility import RandomForestRegressor, featurize
    rng = np.random.default_rng(seed)
    hists = rng.integers(0, 25, (n, s_max + 1)).astype(np.float32)
    X = featurize(hists, 1.0)
    s = np.arange(s_max + 1, dtype=np.float32)
    y = ((hists * (1.2 - 0.3 * s)).sum(1) / np.maximum(hists.sum(1), 1.0)
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    return RandomForestRegressor(n_trees=20, max_depth=6, seed=seed).fit(X, y)


def _tiny_fedspace_run(device, rf, monkeypatch):
    """The tiny world of tests/test_hotpath_parity.py (16 satellites, 1
    day) under FedSpace(I0 8, 64 candidates, seed 11), 64 windows; returns
    (result, the re-plans' schedules)."""
    from repro_torch.core import search as TSR
    from repro_torch.core.scheduler import FedSpaceScheduler
    log = []
    inner = TSR.fedspace_search

    def recording(*args, **kw):
        out = inner(*args, **kw)
        log.append(np.asarray(out).copy())
        return out
    monkeypatch.setattr(TSR, "fedspace_search", recording)
    try:
        C = TCN.connectivity_sets(TCN.ConstellationSpec(num_satellites=16),
                                  days=1.0)
        adapter = MlpFmowAdapter(SyntheticFmow(FmowSpec(num_train=800,
                                                        num_val=200)),
                                 make_clients(iid_partition(800, 16, 0)),
                                 device=device)
        res = SimulationEngine(
            C, adapter, FedSpaceScheduler(rf, I0=8, num_candidates=64,
                                          seed=11),
            EngineConfig(eval_every=8, max_windows=64,
                         stop_at_target=False), device=device).run()
    finally:
        monkeypatch.undo()
    return res, log


@pytest.mark.gpu
def test_fedspace_run_on_the_card_matches_the_cpu(monkeypatch):
    """Counters, staleness histogram and every re-plan's schedule exact,
    card against CPU, with one aggregation launch per aggregation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    rf = _hist_forest()
    launch_counts.clear()
    card, card_log = _tiny_fedspace_run("cuda", rf, monkeypatch)
    assert launch_counts["weighted_aggregate"] == card.num_global_updates > 3
    cpu, cpu_log = _tiny_fedspace_run("cpu", rf, monkeypatch)
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run",
                 "eval_windows"):
        assert getattr(card, name) == getattr(cpu, name), name
    np.testing.assert_array_equal(card.staleness_hist, cpu.staleness_hist)
    assert len(card_log) == len(cpu_log) == 8
    for a, b in zip(card_log, cpu_log):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(card.accuracy, cpu.accuracy,
                               atol=1.0 / 200 + 1e-6)


@pytest.mark.gpu
def test_phase1_samples_repeat_bit_for_bit_on_the_card():
    """Two generations of the eq.-12 samples on one trajectory on the
    card give the same (X, y) bits: the accumulation has a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    from repro_torch.fl.fedspace_setup import (phase1_samples,
                                               pretrain_trajectory)
    adapter = MlpFmowAdapter(SyntheticFmow(FmowSpec(num_train=800,
                                                    num_val=200)),
                             make_clients(iid_partition(800, 16, 0)),
                             device="cuda")
    traj = pretrain_trajectory(adapter, rounds=6, clients_per_round=8,
                               local_steps=4, client_lr=1.0, seed=0)
    kw = dict(n_samples=48, s_max=8, clients_per_sample=16, local_steps=4,
              client_lr=1.0, seed=0)
    X1, y1 = phase1_samples(adapter, traj, **kw)
    X2, y2 = phase1_samples(adapter, traj, **kw)
    np.testing.assert_array_equal(X1, X2)
    np.testing.assert_array_equal(y1, y2)
    assert np.abs(y1).max() > 0


@pytest.mark.gpu
def test_the_search_keeps_its_tensors_on_the_card():
    """A re-plan on a world on the card makes no tensor on the CPU but the
    (R,) score vector it brings back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    from torch.overrides import TorchFunctionMode
    from repro_torch.core.scheduler import FedSpaceScheduler

    class CpuTensors(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in outs):
                self.made.append(getattr(func, "__name__", str(func)))
            return out

    C = TCN.connectivity_sets(TCN.ConstellationSpec(num_satellites=16),
                              days=1.0)
    state = TS.bootstrap_state(16, device="cuda")
    sched = FedSpaceScheduler(_hist_forest(), I0=24, n_min=4, n_max=8,
                              num_candidates=500)
    with CpuTensors() as mode:
        sched.decide(0, n_in_buffer=1, K=16, state=state, ig=0,
                     connectivity=C, status=1.0)
    assert sched._schedule is not None and sched._schedule.sum() >= 4
    assert set(mode.made) == {"cpu"}, mode.made


@pytest.mark.gpu
def test_densenet_client_update_on_the_card():
    """A masked batched DenseNet client update (Part-A widths, 8
    satellites, 4 steps at lr 0.3) on the card: within tolerance of the
    CPU's from the same parameters and batches (a ReLU input rounding to 0
    on one device and not the other moves a leaf by ~1e-4 a step), frozen
    deltas exactly 0, and two calls bit for bit alike (cuDNN made
    deterministic, TF32 off, by the adapter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    from repro_torch.fl.adapters import DenseNetFmowAdapter
    from repro_torch.fl.client import make_batched_client_update
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import params_from_numpy, params_to_numpy
    data = SyntheticFmow(FmowSpec(num_train=600, num_val=64, noise=1.0))
    clients = make_clients(iid_partition(600, 8, 0))
    widths = dict(growth=8, blocks=(2, 2, 2), stem=16, frozen_blocks=1)
    cpu = DenseNetFmowAdapter(data, clients, device="cpu", **widths)
    card = DenseNetFmowAdapter(data, clients, device="cuda", **widths)
    p0 = params_to_numpy(cpu.init(torch.Generator().manual_seed(0)))
    outs = []
    for adapter in (card, card, cpu):
        batch, rows = adapter.client_batch_many(list(range(8)), 0, 32, 4)
        assert rows == list(range(8))
        params = params_from_numpy(p0, adapter.device)
        update = make_batched_client_update(
            adapter, local_steps=4, lr=0.3,
            trainable_mask=adapter.trainable_mask(params))
        outs.append(tree_leaves(update(params, batch)))
    mask = tree_leaves(cpu.trainable_mask(p0))
    for a, b, c, m in zip(*outs, mask):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-2, atol=1e-2)
        if m == 0.0:
            assert not a.any() and not c.any()


def _scenario_exp(kind, **params):
    """tests/test_torch_isl.py's tiny world: 12 satellites in 3 polar
    planes over the 4-station network, 18 hours, under a binding budget
    (need_up 4, one satellite a station) with one-window ISL hops."""
    shell = TCN.Shell(12, 3, 560_000.0, 97.6)
    return TA.FLExperiment(
        constellation=TA.ConstellationConfig(
            num_satellites=12, days=0.75, ground="mid4",
            spec_overrides={"shells": (shell,), "min_elevation_deg": 25.0}),
        dataset=TA.DatasetConfig(num_train=600, num_val=200, noise=2.2),
        partition=TA.PartitionConfig(kind="noniid"),
        adapter=TA.AdapterConfig(kind="mlp", params={"hidden": 16}),
        scheduler=TA.SchedulerConfig(kind, params=params),
        train=EngineConfig(local_steps=2, client_lr=0.5, eval_every=24,
                           stop_at_target=False),
        link=TA.LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                           model_mb=600.0, gs_capacity=1),
        isl=TA.ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,params", [("fedbuff", {"M": 3}),
                                         ("intra_plane", {}),
                                         ("isl_async", {})])
def test_budget_and_isl_runs_on_the_card_match_the_cpu(kind, params):
    """A run under the link budget (fedbuff) and the two ISL runs: every
    counter, the staleness histogram and the protocol columns (`progress`,
    `relay`) card against CPU, one aggregation launch per aggregation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    from repro_torch.weights import params_to_numpy
    exp = _scenario_exp(kind, **params)
    card_fed = TA.Federation.from_experiment(exp)
    p0 = params_to_numpy(card_fed.adapter.init(
        torch.Generator().manual_seed(0)))
    launch_counts.clear()
    card = card_fed.engine(init_params=p0)
    cres = card.run()
    assert launch_counts["weighted_aggregate"] == \
        cres.num_global_updates >= 3
    cpu = TA.Federation.from_experiment(exp, device="cpu").engine(
        init_params=p0, device="cpu")
    pres = cpu.run()
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run",
                 "eval_windows"):
        assert getattr(cres, name) == getattr(pres, name), name
    np.testing.assert_array_equal(cres.staleness_hist, pres.staleness_hist)
    for name in ("version", "pending", "buffered_base", "transfer_progress"):
        np.testing.assert_array_equal(getattr(card, name),
                                      getattr(cpu, name), err_msg=name)
    if kind == "intra_plane":
        np.testing.assert_array_equal(card.relay_units, cpu.relay_units)
    else:
        assert card.relay_units is None and cpu.relay_units is None
    np.testing.assert_allclose(cres.accuracy, pres.accuracy,
                               atol=1.0 / 200 + 1e-6)


FAULTS = dict(deorbit=((1, 10), (5, 20), (9, 30)), launch=((5, 40), (11, 25)),
              outages=((0, 30, 50),), rate_scale_min=0.5,
              rate_scale_max=1.0, seed=2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,params", [("fedbuff", {"M": 3}),
                                         ("intra_plane", {"M": 6}),
                                         ("isl_async", {})])
def test_faulted_runs_on_the_card_match_the_cpu(kind, params):
    """Churn, launches, an outage and weather under the budget, with sink
    relaying and gossip: every counter, the histogram and the protocol
    columns card against CPU, one aggregation launch per aggregation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    from repro_torch.weights import params_to_numpy
    faults = TA.FaultConfig(**FAULTS)
    card_fed = TA.Federation.from_experiment(_scenario_exp(kind, **params))
    card_fed = card_fed.with_faults(faults)
    assert card_fed.device.type == "cuda"
    p0 = params_to_numpy(card_fed.adapter.init(
        torch.Generator().manual_seed(0)))
    launch_counts.clear()
    card = card_fed.engine(init_params=p0)
    cres = card.run()
    assert launch_counts["weighted_aggregate"] == \
        cres.num_global_updates >= 3
    cpu = TA.Federation.from_experiment(
        _scenario_exp(kind, **params), device="cpu").with_faults(
        faults).engine(init_params=p0, device="cpu")
    pres = cpu.run()
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run"):
        assert getattr(cres, name) == getattr(pres, name), name
    np.testing.assert_array_equal(cres.staleness_hist, pres.staleness_hist)
    for name in ("version", "pending", "buffered_base", "transfer_progress",
                 "relay_units"):
        a, b = getattr(card, name), getattr(cpu, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.gpu
def test_sweep_on_the_card_matches_the_cpu_without_a_host_sync():
    """The six sweepable policies, clean and faulted, through `run_sweep`
    on the card (its window loops under sync debug mode "error") and on
    the CPU: every outcome equal, no kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with nvcc")
    from repro_torch.fl import sweep
    policies = [("sync", {}), ("async", {}), ("fedbuff", {"M": 3}),
                ("periodic", {"period": 3}), ("intra_plane", {"M": 6}),
                ("isl_async", {})]
    sides = {}
    for device in ("cuda", "cpu"):
        base = TA.Federation.from_experiment(_scenario_exp("sync"),
                                             device=device)
        worlds = [base.with_faults(f).with_scheduler(k, **p)
                  for f in (None, TA.FaultConfig(**FAULTS))
                  for k, p in policies]
        engines = [w.engine(device=w.device) for w in worlds]
        inner = sweep._window_loop

        def guarded(cols, **kw):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return inner(cols, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        launch_counts.clear()
        sweep._window_loop = guarded if device == "cuda" else inner
        try:
            sides[device] = sweep.sweep_engines(engines)
        finally:
            sweep._window_loop = inner
        assert not sum(launch_counts.values())
    for a, b in zip(sides["cuda"], sides["cpu"]):
        assert a.result.summary() == b.result.summary()
        for name in ("version", "pending", "buffered"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
    assert len({o.result.num_global_updates for o in sides["cuda"]}) > 3
