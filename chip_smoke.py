#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit) when it fails:
  1. device: the card's name, count, and `nvidia-smi` name/power limit;
  2. build: every CUDA source of the port (aggregation, RMSNorm, flash
     attention on the CUDA cores, its forward and its backward on the
     tensor cores) built with nvcc for sm_90a, one nvcc per source, all
     started together, with ptxas's report (and a summary of the
     tensor-core kernels' registers and spills, which must be none);
  3. kernels against their plain PyTorch versions, forward and backward,
     at the main paths' shapes, the reference's test sweeps and one large
     shape each, with CUDA-event timings (kernel, plain version, one-call
     library yardstick) beside the least time the card could take for the
     same work; for RMSNorm also the device and host time of a call and
     its kernels per call, two backward calls compared bit for bit, the
     other layouts' times at the zoo shape, and the host cost of the
     pieces of a wrapper call; for attention the route (tensor cores or
     CUDA cores) of both directions on every row, checked against the
     launch counts, the tensor-core backward's errors with P and dS in one
     bf16 part and in two, and at the path's and the zoo shape the device
     and host time of a call and its kernels per call (the zoo forward
     one tensor-core kernel, its backward three, each timed), with the
     CUDA-core route's time on the zoo inputs beside them;
  4. the quickstart path: the FedBuff federation of examples/quickstart.py
     (MLP payload) through `Federation.from_experiment(exp).run()` on the
     card, launch counts read around it, then the same experiment on the
     CPU as the check;
  5. the transformer path: the same FedBuff world with the transformer
     payload (RMSNorm and attention in the kernels, forward and backward)
     on the card, launch counts read around it, then on the CPU, and one
     batched client update of 20 satellites held leaf by leaf against the
     CPU's from the same parameters and batches, beside the spread of the
     CPU's and of the card's own update under a 1e-7 nudge;
  6. one JSON line listing every ported kernel.
The last line is `{"ok": true,
"device": {...}}`. Without a CUDA device, or away from the repository's
sources, it exits nonzero and prints no result. Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM rate, float32 outside the tensor
# cores, and bf16 on the tensor cores. The aggregation and RMSNorm do
# their arithmetic on the CUDA cores in float32; attention's operations
# are bounded by the tensor cores' bf16 rate, the least time the card
# could take for them, though its CUDA-core route runs in float32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
QUICKSTART_LEAVES = (1536, 48, 2976, 62)   # w1, b1, w2, b2 of F=32->48->62
PAPER_N = 26_608_958                       # DenseNet-161, 62-class head
PAPER_M = 191                              # flock191 satellites
MAIN_PATH_M = 20                           # fedbuff M of the quickstart
AGG_TOL = 2e-5      # float32 outputs: the same products summed in another
                    # order (the float32 tolerance of tests/test_kernels.py)


def _time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(moved_bytes, ops, flop_per_s):
    """(least ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over `flop_per_s`."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _agg_bound(m: int, n: int, upd_bytes: int, par_bytes: int = 4):
    """Least time for one aggregation: every input read once, the output
    written once, against 2*M*N float32 operations."""
    return _bound((m * upd_bytes + 2 * par_bytes) * n + 4 * m, 2 * m * n,
                  FP32_FLOP_PER_S)


def check_aggregation(torch):
    """Phase 3: the agg kernel against its plain version at every shape."""
    from repro_torch.kernels.agg.kernel import weighted_aggregate
    from repro_torch.kernels.agg.ref import weighted_aggregate_ref
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(m, n) for n in QUICKSTART_LEAVES for m in (1, MAIN_PATH_M, 40)]
    shapes.append((PAPER_M, PAPER_N))
    rows = []
    for m, n in shapes:
        for udt in (torch.float32, torch.bfloat16):
            upd = torch.randn(m, n, generator=g, device="cuda", dtype=udt)
            p = torch.randn(n, generator=g, device="cuda")
            w = torch.rand(m, generator=g, device="cuda")
            w /= w.sum()
            out = weighted_aggregate(p, upd, w)
            ref = weighted_aggregate_ref(p, upd, w)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = bool(torch.allclose(out, ref, rtol=AGG_TOL, atol=AGG_TOL))
            iters = 10 if n == PAPER_N else 200
            k_ms = _time_ms(lambda: weighted_aggregate(p, upd, w), iters)
            p_ms = _time_ms(lambda: weighted_aggregate_ref(p, upd, w), iters)
            # one PyTorch call computing the same function (a cuBLAS
            # gemv); none takes bfloat16 updates into float32 params
            lib_ms = _time_ms(lambda: torch.addmv(p, upd.t(), w), iters) \
                if udt == torch.float32 else None
            bound, by = _agg_bound(m, n, upd.element_size())
            row = {"m": m, "n": n, "updates": str(udt).split(".")[-1],
                   "max_abs_err": err, "tol": AGG_TOL, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by,
                   "bound_share": bound / k_ms}
            print("agg", json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"agg kernel disagrees with its plain "
                                     f"version at {row}")
            rows.append(row)
            del upd, p, w, out, ref
    torch.cuda.empty_cache()
    return rows


def _tol(dtype, grad: bool = False):
    """(rtol, atol) of a kernel against its plain version on the card.
    float32: the same float32 arithmetic summed in another order (the
    float32 tolerance of tests/test_kernels.py; 1e-4 for gradients, which
    sum up to tens of thousands of products). bfloat16: both round the
    same float32 result once, and a result near a rounding boundary may
    round the other way, by one unit in the last place: at most 2**-7 of
    the value, under rtol 1e-2; atol 1e-2 covers values near 0. The
    largest bfloat16 errors this script has read on an H100 are 0.0039 and
    0.016 (attention forward and backward, qwen3-8b's heads at S=2048),
    0.0156 (RMSNorm at (16384, 4096): one unit at outputs of 2 to 4) and
    0.5 (its dscale: sums over 16384 rows, a few hundred, where one unit
    is 1 or 2)."""
    import torch
    if dtype == torch.bfloat16:
        return 1e-2, 1e-2
    return (1e-4, 1e-4) if grad else (2e-5, 2e-5)


def _compare(name, outs, refs, dtype, grad=False):
    """Largest |kernel - plain| over outputs; raises beyond tolerance.
    An entry that is -inf in both (the log-sum-exp of a row that sees no
    key) counts as equal; -inf in one alone fails."""
    import torch
    rtol, atol = _tol(dtype, grad)
    err = 0.0
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        same_inf = torch.isinf(r) & (o == r)
        err = max(err, torch.where(same_inf, 0.0, o - r).abs().max().item())
        if not torch.allclose(o, r, rtol=rtol, atol=atol):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max |diff| {err}, rtol {rtol},"
                                 f" atol {atol})")
    return err, f"rtol {rtol}, atol {atol}"


def _grad_ms(fn, inputs, cotangent, iters):
    """Time of the backward alone of one call of `fn` (graph built once)."""
    import torch
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return _time_ms(lambda: torch.autograd.grad(out, leaves, cotangent,
                                                retain_graph=True), iters)


# RMSNorm shapes (G scale rows, R rows each, D), dtype, and the offset in
# elements at which x starts in its buffer: the transformer path's
# training call (20 satellites x 32 samples x 8 tokens, d_model 32) and
# evaluation call (1000 samples x 8 tokens, one scale), the sweep of
# tests/test_kernels.py, one zoo width, and the edges of the kernels'
# paths: a width of 72 bytes (the 1-wide path), an x one element into its
# buffer (unaligned: the 1-wide path), several groups whose rows are no
# multiple of a tile, and rows wider than the registers hold (the
# row-looping kernels): D = 20,000 float32 (one tile), 32,768 bfloat16 and
# 4,100 float32 one element into its buffer (several tiles a group).
RMS_PATH = (20, 256, 32)
RMS_ZOO = (1, 16384, 4096)
RMS_SHAPES = [(RMS_PATH, "float32", 0), ((1, 8000, 32), "float32", 0)] + [
    (shape, dt, 0) for shape in ((1, 4, 128), (1, 15, 256), (1, 37, 512))
    for dt in ("float32", "bfloat16")] + [
    (RMS_ZOO, "bfloat16", 0), ((4, 300, 36), "bfloat16", 0),
    ((2, 100, 256), "float32", 1), ((8, 1000, 1024), "float32", 0),
    ((1, 16, 20_000), "float32", 0), ((2, 40, 32_768), "bfloat16", 0),
    ((3, 300, 4_100), "float32", 1)]
RMS_EPS = 1e-6


def _host_and_device(fn, iters):
    """Per call of `fn`: host microseconds (host clock over `iters` calls,
    no synchronising inside); device microseconds per kernel and kernels
    launched per call, from `torch.profiler`'s `key_averages()` over
    `iters` calls; the names of the kernels seen; and the kernel events
    the profiler recorded. On the H100 machines the profiler drops some
    kernel events (1 to 39 of 200 in a few runs), never adds any: the
    kernels per call are the events over the calls rounded up, and the
    device time per call the device time per event times that. Also each
    kernel's device microseconds per event, by name."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us, events, names, by_name = 0.0, 0, [], {}
    for e in prof.key_averages():
        # device-side events only: host ops also report the device time
        # of the kernels they launched
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0) if t is None else t
        if t > 0:
            dev_us += t
            events += e.count
            names.append(e.key)
            by_name[e.key] = t / e.count
    if dev_us <= 0:
        raise AssertionError("torch.profiler shows no device time")
    per_call = -(-events // iters)
    return (host_us, dev_us / events * per_call, per_call, names, events,
            by_name)


def _rms_layouts(K, x, scale, rstd, dy, refs):
    """At the zoo shape: the kernels' time under each layout the wrapper
    could choose (threads per row x loads per thread), each checked
    against the plain version; the default is the first of each."""
    G, R, D = x.shape
    vec = K.vector_width(D, x.element_size(), x.data_ptr())
    out = {}
    for direction, default, choices, run in (
            ("fwd", K.FWD_LOADS, (2, 4, 8, 16),
             lambda m: K._fwd(x, scale, RMS_EPS, G, R, D, m)),
            ("bwd", K.BWD_LOADS, (2, 4, 8),
             lambda m: K._bwd(x, scale, rstd, dy, G, R, D, m))):
        assert choices[0] == default
        times = {}
        for m in choices:
            t, nl = K.layout(D // vec, vec > 1, m)
            got = run(m)
            _compare(f"rmsnorm {direction} layout {m}", got[:1], refs[
                direction], x.dtype, grad=direction == "bwd")
            times[f"{1 << t} threads x {nl} loads"] = _time_ms(
                lambda: run(m), 20)
        out[direction] = times
    return out


def _rms_host_pieces(K, torch):
    """Host microseconds of the pieces of one wrapper call at the path's
    training shape (5,000 calls of each after 100 of warm-up, no
    synchronising): the checks, the allocations (two, as the wrapper makes
    them, against one shared through views), the stream lookup (the raw
    pointer the wrapper reads, against `current_stream().cuda_stream`),
    the ctypes call alone (zero rows: no launch), and whole calls."""
    G, R, D = RMS_PATH
    x = torch.randn(G, R, D, device="cuda")
    scale = torch.randn(G, D, device="cuda")
    y, rstd = K.rmsnorm(x, scale, RMS_EPS)
    fwd, bwd = K._library()
    n, rows, dev = x.numel(), G * R, x.device

    def one_allocation():
        buf = torch.empty(n + rows, device=dev)
        a, b = buf.split([n, rows])
        return a.view(x.shape), b

    pieces = {
        "checks": lambda: K._check(x, scale),
        "two allocations": lambda: (torch.empty_like(x), torch.empty(
            rows, device=dev)),
        "one allocation, split and view": one_allocation,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "ctypes call, no launch (fwd)": lambda: fwd(
            0, 0, 0, 0, 0, 0, 0, 0.0, 0, 4, 3, 1, 0),
        "ctypes call, no launch (bwd)": lambda: bwd(
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 3, 1, 0),
        "whole call (fwd)": lambda: K.rmsnorm(x, scale, RMS_EPS),
        "whole call (bwd)": lambda: K.rmsnorm_bwd(x, scale, rstd, x),
    }
    out = {}
    for name, fn in pieces.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5000):
            fn()
        out[name] = (time.perf_counter() - t0) / 5000 * 1e6
        torch.cuda.synchronize()
    print("rmsnorm host_us", json.dumps(out), flush=True)
    return out


def check_rmsnorm(torch):
    """Phase 3: RMSNorm forward and backward against the plain version,
    with the host and device time of a call and its kernel count."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_ref,
                                                 rmsnorm_fwd_ref)
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for (G, R, D), dts, off in RMS_SHAPES:
        dt = getattr(torch, dts)
        x = torch.randn(G * R * D + off, generator=g, device="cuda").to(dt)[
            off:].view(G, R, D)
        scale = (1 + 0.5 * torch.randn(G, D, generator=g, device="cuda")
                 ).to(dt)
        dy = torch.randn(G, R, D, generator=g, device="cuda").to(dt)
        y, rstd = K.rmsnorm(x, scale, RMS_EPS)
        y_ref, rstd_ref = rmsnorm_fwd_ref(x, scale, RMS_EPS)
        dx, ds = K.rmsnorm_bwd(x, scale, rstd, dy)
        dx2, ds2 = K.rmsnorm_bwd(x, scale, rstd, dy)
        # the plain backward starts from the plain forward's rstd
        dx_ref, ds_ref = rmsnorm_bwd_ref(x, scale, rstd_ref, dy)
        torch.cuda.synchronize()
        tag = f"rmsnorm G={G} R={R} D={D} {dts} offset={off}"
        fwd_err, fwd_tol = _compare(tag, (y,), (y_ref,), dt)
        rstd_err, _ = _compare(tag + " rstd", (rstd,), (rstd_ref,),
                               torch.float32)
        fwd_err = max(fwd_err, rstd_err)
        bwd_err, bwd_tol = _compare(tag + " bwd", (dx, ds), (dx_ref, ds_ref),
                                    dt, grad=True)
        if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
            raise AssertionError(f"{tag}: two backward calls differ")
        big = x.numel() >= 1 << 24
        iters = 20 if big else 200
        n, b = x.numel(), x.element_size()
        sb = scale.numel() * scale.element_size()
        fwd_bound = _bound(2 * n * b + sb + 4 * G * R, 4 * n,
                           FP32_FLOP_PER_S)
        bwd_bound = _bound(3 * n * b + 2 * sb + 4 * G * R, 10 * n,
                           FP32_FLOP_PER_S)
        vec = K.vector_width(D, b, x.data_ptr(), scale.data_ptr())
        shared = G == 1    # one PyTorch call takes one (D,) scale only
        for direction, err, tol, bound, kern, plain, lib, loads in (
                ("fwd", fwd_err, fwd_tol, fwd_bound,
                 lambda: K.rmsnorm(x, scale, RMS_EPS),
                 lambda: rmsnorm_fwd_ref(x, scale, RMS_EPS),
                 (lambda: F.rms_norm(x, (D,), scale[0], RMS_EPS))
                 if shared else None, K.FWD_LOADS),
                ("bwd", bwd_err, bwd_tol, bwd_bound,
                 lambda: K.rmsnorm_bwd(x, scale, rstd, dy),
                 lambda: rmsnorm_bwd_ref(x, scale, rstd, dy), None,
                 K.BWD_LOADS)):
            k_ms = _time_ms(kern, iters)
            p_ms = _time_ms(plain, iters)
            if direction == "fwd":
                lib_ms = _time_ms(lib, iters) if lib else None
            else:
                lib_ms = _grad_ms(
                    lambda a, w: F.rms_norm(a, (D,), w[0], RMS_EPS),
                    (x, scale), dy, iters) if shared else None
            host_us, dev_us, per_call, names, events, _ = _host_and_device(
                kern, iters)
            if per_call != 1 or len(names) != 1:
                raise AssertionError(f"{tag} {direction}: {per_call} "
                                     f"kernels per call ({names}), not 1")
            tpr_log2, nl = K.layout(D // vec, vec > 1, loads)
            row = {"kernel": "rmsnorm" if direction == "fwd"
                   else "rmsnorm_bwd", "G": G, "R": R, "D": D, "dtype": dts,
                   "x_offset": off, "vector": vec,
                   "threads_per_row": 1 << tpr_log2, "loads": nl,
                   "max_abs_err": err, "tol": tol, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": lib_ms,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "bound_share": bound[0] / k_ms, "device_us": dev_us,
                   "host_us": host_us, "launches_per_call": per_call,
                   "profiled": f"{events} kernel events over {iters} calls"}
            if direction == "bwd":
                row["tiles"] = K.tiles(G, R, tpr_log2)
                row["repeats_bitwise"] = True
            print("rmsnorm", json.dumps(row), flush=True)
            rows.append(row)
        if (G, R, D) == RMS_ZOO:
            layouts = _rms_layouts(K, x, scale, rstd, dy, {
                "fwd": (y_ref,), "bwd": (dx_ref,)})
            print("rmsnorm layouts", json.dumps(layouts), flush=True)
        del x, scale, dy, y, rstd, y_ref, rstd_ref, dx, ds, dx2, ds2
        del dx_ref, ds_ref
    _rms_host_pieces(K, torch)
    torch.cuda.empty_cache()
    return rows


# Flash-attention shapes (B, H, K, Sq, Sk, hd, causal, window, dtype): the
# transformer path's training call (20 satellites x 32 samples, 4 heads
# over 2 kv heads, 8 tokens, hd 8), the two sweeps of tests/test_kernels.py
# (GQA x mask at S=128, hd=64, in float32 and in bfloat16, the tensor
# cores' route; Sq/Sk x dtype at hd=128, unmasked), head dims the kernels
# do not instantiate (80 in bfloat16, padded to 128 on the tensor cores;
# 12 in float32, padded to 16 on the CUDA cores; 300 in bfloat16 with a
# window of 3 and 1,000 in float32, padded to 512 and 1,024 for the CUDA
# cores' row-looping kernels), and qwen3-8b's head layout at S=2048
# (configs/qwen3_8b.py).
FLASH_PATH = (640, 4, 2, 8, 8, 8, True, 0, "float32")
FLASH_ZOO = (1, 32, 8, 2048, 2048, 128, True, 0, "bfloat16")
FLASH_SHAPES = [FLASH_PATH] + [
    (2, h, k, 128, 128, 64, causal, window, dt)
    for dt in ("float32", "bfloat16")
    for h, k in ((4, 4), (4, 2), (8, 1))
    for causal, window in ((True, 0), (True, 32), (False, 0))] + [
    (1, 2, 2, sq, sk, 128, False, 0, dt)
    for sq, sk in ((64, 64), (100, 200), (64, 192))
    for dt in ("float32", "bfloat16")] + [
    (1, 4, 2, 100, 200, 80, True, 0, "bfloat16"),
    (2, 4, 2, 64, 64, 12, True, 3, "float32"),
    (1, 4, 2, 128, 128, 300, True, 3, "bfloat16"),
    (1, 4, 2, 128, 128, 1000, True, 0, "float32"), FLASH_ZOO]
TC_KERNEL = "flash_fwd_tc_kernel"     # in the tensor-core kernel's name
TC_BWD_KERNELS = ("flash_bwd_tc_delta_kernel", "flash_bwd_tc_dkdv_kernel",
                  "flash_bwd_tc_dq_kernel")   # in the backward's


def _visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask keeps: the work this run's inputs need."""
    total = 0
    for i in range(sq):
        hi = min(sk - 1, i) if causal else sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _cuda_core_fwd(K, q, k, v, causal, window):
    """The CUDA-core forward called through its C entry point, whatever
    route the wrapper would pick (for an unpadded hd)."""
    import torch
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = K._library()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(),
                          *K._dims(q, k, causal, window, q.shape[-1]))
    if err:
        raise RuntimeError(f"flash_fwd_launch failed with cudaError {err}")
    return o, lse


def _bwd_direct(K, q, k, v, o, lse, do, causal, window, parts=None):
    """A backward called through its C entry point, not counted, on inputs
    zero-padded as the wrapper pads them: the CUDA-core kernels, or with
    `parts` the tensor-core kernels with P and dS in that many bf16
    parts."""
    import torch
    hd = q.shape[-1]
    width = K.padded_head_dim(hd)
    q, k, v, o, do = (K.pad_head_dim(t, width) for t in (q, k, v, o, do))
    grads = [torch.empty_like(t) for t in (q, k, v)]
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    launch, extra = ((K._library()[1], ()) if parts is None
                     else (K._library_bwd_tc(), (parts,)))
    err = launch(*(t.data_ptr() for t in (q, k, v, o, lse, do, *grads,
                                          delta)),
                 *K._dims(q, k, causal, window, hd), *extra)
    if err:
        raise RuntimeError(f"backward launch failed with cudaError {err}")
    return [t[..., :hd] for t in grads]


def _errs(outs, refs, dtype):
    """(largest |kernel - plain|, largest share of the tolerance
    |kernel - plain| / (atol + rtol |plain|)) over outputs, without
    failing: above 1 a check would fail."""
    rtol, atol = _tol(dtype, grad=True)
    diffs = [((o.float() - r.float()).abs(), r.float().abs())
             for o, r in zip(outs, refs)]
    return (max(d.max().item() for d, _ in diffs),
            max((d / (atol + rtol * m)).max().item() for d, m in diffs))


def _tc_bwd_kernels(names):
    """Whether the kernels seen are the three of the tensor-core backward,
    each once."""
    return len(names) == 3 and all(
        sum(t in n for n in names) == 1 for t in TC_BWD_KERNELS)


def check_flash(torch):
    """Phase 3: flash attention forward and backward against the plain
    version."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import (_mask,
                                                         attention_bwd_ref,
                                                         attention_fwd_ref)
    from repro_torch.kernels import launch_counts
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape in FLASH_SHAPES:
        B, H, KH, sq, sk, hd, causal, window, dts = shape
        dt = getattr(torch, dts)
        q = torch.randn(B, H, sq, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, KH, sk, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, KH, sk, hd, generator=g, device="cuda").to(dt)
        do = torch.randn(B, H, sq, hd, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=window)
        route = K.route(dt, K.padded_head_dim(hd))
        before = dict(launch_counts)
        o, lse = K.flash_attention(q, k, v, **kw)
        o_ref, lse_ref = attention_fwd_ref(q, k, v, **kw)
        grads = K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        for name in (K.NAME_TC, K.NAME_BWD_TC):
            if launch_counts[name] - before.get(name, 0) != (route == "tc"):
                raise AssertionError(f"{shape}: route {route} but "
                                     f"{launch_counts[name]} {name} "
                                     f"launches")
        # the plain backward starts from the plain forward's o and lse
        grads_ref = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        torch.cuda.synchronize()
        tag = (f"flash B={B} H={H} K={KH} Sq={sq} Sk={sk} hd={hd} "
               f"causal={causal} window={window} {dts}")
        fwd_err, fwd_tol = _compare(tag, (o,), (o_ref,), dt)
        lse_err, _ = _compare(tag + " lse", (lse,), (lse_ref,),
                              torch.float32)
        fwd_err = max(fwd_err, lse_err)
        bwd_err, bwd_tol = _compare(tag + " bwd", grads, grads_ref, dt,
                                    grad=True)
        big = sq * sk * B * H >= 1 << 24
        iters = 10 if big else 100
        b = q.element_size()
        qo = q.numel() * b                 # bytes of q (and of o, do, dq)
        kv = k.numel() * b                 # bytes of k (and of v, dk, dv)
        lse_b = 4 * B * H * sq
        fwd_ops = 4 * hd * B * H * _visible_pairs(sq, sk, causal, window)
        fwd_bound = _bound(2 * qo + 2 * kv + lse_b, fwd_ops,
                           BF16_TC_FLOP_PER_S)
        bwd_bound = _bound(4 * qo + 4 * kv + lse_b, 2.5 * fwd_ops,
                           BF16_TC_FLOP_PER_S)
        # one PyTorch call computing the same function (no row here is
        # fully masked, where SDPA and the kernel differ)
        mask = _mask(sq, sk, causal, window, q.device) if window else None

        def sdpa(a, b_, c):
            return F.scaled_dot_product_attention(
                a, b_, c, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True)
        for direction, err, tol, bound, kern, plain in (
                ("fwd", fwd_err, fwd_tol, fwd_bound,
                 lambda: K.flash_attention(q, k, v, **kw),
                 lambda: attention_fwd_ref(q, k, v, **kw)),
                ("bwd", bwd_err, bwd_tol, bwd_bound,
                 lambda: K.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                 lambda: attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                           **kw))):
            k_ms = _time_ms(kern, iters)
            p_ms = _time_ms(plain, iters)
            lib_ms = (_time_ms(lambda: sdpa(q, k, v), iters)
                      if direction == "fwd"
                      else _grad_ms(sdpa, (q, k, v), do, iters))
            row = {"kernel": "flash_attention" if direction == "fwd"
                   else "flash_attention_bwd", "B": B, "H": H, "K": KH,
                   "Sq": sq, "Sk": sk, "hd": hd, "causal": causal,
                   "window": window, "dtype": dts,
                   "route": route, "max_abs_err": err,
                   "tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "library_ms": lib_ms, "bound_ms": bound[0],
                   "bound_by": bound[1], "bound_share": bound[0] / k_ms}
            if shape == FLASH_ZOO and direction == "fwd":
                # the CUDA-core forward on the same inputs, launched through
                # its C entry point (not counted): the route this replaced
                cc = _cuda_core_fwd(K, q, k, v, causal, window)
                _compare(tag + " cuda-core", cc[:1], (o_ref,), dt)
                row["cuda_core_ms"] = _time_ms(
                    lambda: _cuda_core_fwd(K, q, k, v, causal, window), iters)
            if direction == "bwd" and route == "tc":
                # P and dS in one bf16 part and in two, through the C entry
                # point (not counted), against the same plain backward
                row["bwd_tc_parts"] = K.BWD_TC_PARTS
                errs = {parts: _errs(_bwd_direct(K, q, k, v, o, lse, do,
                                                 causal, window, parts),
                                     grads_ref, dt) for parts in (1, 2)}
                row["max_abs_err_by_parts"] = {p: e[0]
                                               for p, e in errs.items()}
                row["tol_share_by_parts"] = {p: e[1]
                                             for p, e in errs.items()}
            if shape == FLASH_ZOO and direction == "bwd":
                # the CUDA-core backward on the same inputs, and the other
                # number of parts: the route and the design this replaced
                cc = _bwd_direct(K, q, k, v, o, lse, do, causal, window)
                _compare(tag + " bwd cuda-core", cc, grads_ref, dt,
                         grad=True)
                row["cuda_core_ms"] = _time_ms(
                    lambda: _bwd_direct(K, q, k, v, o, lse, do, causal,
                                        window), iters)
                row["ms_by_parts"] = {parts: _time_ms(
                    lambda: _bwd_direct(K, q, k, v, o, lse, do, causal,
                                        window, parts), iters)
                    for parts in (1, 2)}
            if shape in (FLASH_PATH, FLASH_ZOO):
                host_us, dev_us, per_call, names, events, by_name = \
                    _host_and_device(kern, iters)
                row.update(device_us=dev_us, host_us=host_us,
                           launches_per_call=per_call, kernels_seen=names,
                           device_us_by_kernel=by_name,
                           profiled=f"{events} kernel events over {iters} "
                                    f"calls")
                if direction == "fwd" and (per_call != 1 or len(names) != 1
                                           or (TC_KERNEL in names[0]) !=
                                           (route == "tc")):
                    raise AssertionError(f"{tag}: {per_call} kernels per "
                                         f"call ({names}), not one "
                                         f"{route} kernel")
                if direction == "bwd" and route == "tc" and (
                        per_call != 3 or not _tc_bwd_kernels(names)):
                    raise AssertionError(f"{tag}: {per_call} kernels per "
                                         f"call ({names}), not the three "
                                         f"tensor-core backward kernels")
            print("flash", json.dumps(row), flush=True)
            rows.append(row)
        del q, k, v, do, o, lse, o_ref, lse_ref, grads, grads_ref
    torch.cuda.empty_cache()
    return rows


def quickstart_experiment():
    """The FedBuff row of examples/quickstart.py at its full size."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment,
                                    PartitionConfig, SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="quickstart",
        constellation=ConstellationConfig(num_satellites=40, days=3.0),
        dataset=DatasetConfig(num_train=4000, num_val=1000, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="mlp", params={"hidden": 48}),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 20}),
        train=EngineConfig(local_steps=16, client_lr=1.0, eval_every=12,
                           target_acc=0.35, max_windows=288))


def run_main_path(torch):
    """Phase 4, the quickstart path. Returns the launch counts of the
    card's run."""
    import math
    from repro_torch.fl.api import Federation
    from repro_torch.kernels import launch_counts
    exp = quickstart_experiment()
    launch_counts.clear()
    t0 = time.perf_counter()
    fed = Federation.from_experiment(exp)
    res = fed.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    print("main path (cuda):", json.dumps(res.summary()), flush=True)
    print(f"main path (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, launches {counts}", flush=True)
    updates = res.num_global_updates
    if updates == 0 or counts.get("weighted_aggregate") != 4 * updates:
        raise AssertionError(f"expected 4 agg launches per aggregation "
                             f"({updates} aggregations), got {counts}")
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")

    t0 = time.perf_counter()
    cpu = Federation.from_experiment(exp, device="cpu").run()
    print("main path (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    # accuracy counts argmax hits on 1000 validation samples; float32
    # products summed in another order on the card may flip a few of them
    _close_accuracy(res, cpu, 0.01)
    return counts


def _same_counters(res, cpu):
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run",
                 "eval_windows"):
        if getattr(res, name) != getattr(cpu, name):
            raise AssertionError(f"{name}: card {getattr(res, name)} vs "
                                 f"CPU {getattr(cpu, name)}")
    if res.staleness_hist.tolist() != cpu.staleness_hist.tolist():
        raise AssertionError("staleness histograms differ")


def _close_accuracy(res, cpu, tol):
    acc_err = abs(res.accuracy[-1] - cpu.accuracy[-1])
    print(f"final accuracy: card {res.accuracy[-1]} CPU {cpu.accuracy[-1]}"
          f" (|diff| {acc_err}, tolerance {tol})", flush=True)
    if acc_err > tol:
        raise AssertionError("final accuracy differs beyond tolerance")


def transformer_experiment():
    """The quickstart's FedBuff world with the transformer payload at the
    adapter's own width (d_model 32, 2 layers, 4 heads over 2 kv heads,
    swiglu d_ff 64, the 32 features read as 8 tokens of width 4), no
    target accuracy, so the run length cannot depend on floats."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment,
                                    PartitionConfig, SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="quickstart-transformer",
        constellation=ConstellationConfig(num_satellites=40, days=3.0),
        dataset=DatasetConfig(num_train=4000, num_val=1000, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="transformer", params={}),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 20}),
        train=EngineConfig(local_steps=16, client_lr=1.0, eval_every=12,
                           max_windows=288, stop_at_target=False))


# The reference's counters for `transformer_experiment` (FedBuff decides
# on buffer counts alone, so they are the MLP world's): a CPU run of the
# JAX package's Federation on the same experiment.
TRANSFORMER_REFERENCE = {"num_global_updates": 36,
                         "num_aggregated_gradients": 755,
                         "idle_connections": 89, "total_connections": 1300,
                         "windows_run": 288}
TRANSFORMER_LEAVES = 13
# Tolerances of the card against the CPU on the transformer path, float32.
# One SGD step is the gradient itself: the same sums in other orders.
STEP_TOL = 1e-4
# Sixteen steps at lr 1.0 carry a rounding difference forward and grow it:
# `check_client_update` prints, beside the card's difference, how far the
# CPU's own 16-step update moves when its parameters move by 1e-7 of their
# value (one rounding), a few 1e-3 on leaves of magnitude 0.3 to 0.9.
UPDATE_TOL = 2e-2
# The first evaluation (window 11) follows one aggregation of such
# updates, averaged over the satellites; relative to the loss.
FIRST_LOSS_TOL = 1e-3


def run_transformer_path(torch):
    """Phase 5, the transformer path. Returns the launch counts of the
    card's run."""
    import math
    from repro_torch.fl.api import Federation
    from repro_torch.kernels import launch_counts
    exp = transformer_experiment()
    launch_counts.clear()
    t0 = time.perf_counter()
    fed = Federation.from_experiment(exp)
    res = fed.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    print("transformer path (cuda):", json.dumps(res.summary()), flush=True)
    print(f"transformer path (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, launches {counts}", flush=True)
    updates = res.num_global_updates
    if updates == 0 or counts.get("weighted_aggregate") != \
            TRANSFORMER_LEAVES * updates:
        raise AssertionError(f"expected {TRANSFORMER_LEAVES} agg launches "
                             f"per aggregation ({updates} aggregations), "
                             f"got {counts}")
    # every forward makes 5 RMSNorm and 2 attention calls, every backward
    # the same number of backward calls
    fa, fb = counts.get("flash_attention", 0), counts.get(
        "flash_attention_bwd", 0)
    if fb == 0 or 2 * counts.get("rmsnorm", 0) != 5 * fa \
            or 2 * counts.get("rmsnorm_bwd", 0) != 5 * fb:
        raise AssertionError(f"expected rmsnorm = 5/2 flash_attention, "
                             f"forward and backward, with backward calls; "
                             f"got {counts}")
    # the path's attention is float32 at hd 8: the CUDA cores' route, both
    # directions
    if counts.get("flash_attention_tc", 0) or counts.get(
            "flash_attention_bwd_tc", 0):
        raise AssertionError(f"float32 attention took the tensor cores: "
                             f"{counts}")
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    for name, want in TRANSFORMER_REFERENCE.items():
        if getattr(res, name) != want:
            raise AssertionError(f"{name}: card {getattr(res, name)}, "
                                 f"reference {want}")

    t0 = time.perf_counter()
    cpu_fed = Federation.from_experiment(exp, device="cpu")
    cpu = cpu_fed.run()
    print("transformer path (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    first = abs(res.val_loss[0] - cpu.val_loss[0])
    print(f"first val_loss: card {res.val_loss[0]} CPU {cpu.val_loss[0]} "
          f"(|diff| {first}, relative tolerance {FIRST_LOSS_TOL})",
          flush=True)
    if first > FIRST_LOSS_TOL * abs(cpu.val_loss[0]):
        raise AssertionError("first val_loss differs beyond tolerance")
    # 576 SGD steps at lr 1.0 carry the float32 rounding differences of
    # the kernels' and cuBLAS's summation orders forward; an accuracy on
    # 1000 validation samples may move by a few argmax flips
    _close_accuracy(res, cpu, 0.02)
    check_client_update(torch, fed.adapter, cpu_fed.adapter, exp.train)
    return counts


def check_client_update(torch, card, cpu, train):
    """The transformer adapter's batched client update at the path's shape
    (the first 20 satellites, lr 1.0) on the card and on the CPU, from the
    same parameters and batches, compared leaf by leaf: the ops' autograd
    functions (kernels both ways) against autograd of the plain versions.
    It runs after the path's launch counts were read."""
    import numpy as np
    from repro_torch.fl.client import make_batched_client_update
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import params_from_numpy, params_to_numpy
    params = params_to_numpy(cpu.init(torch.Generator().manual_seed(0)))
    runs = []
    for adapter in (card, cpu):
        batch, rows = adapter.client_batch_many(
            list(range(MAIN_PATH_M)), 0, train.batch_size,
            train.local_steps)
        runs.append((adapter, rows, batch))
    (_, rows, batch), (_, rows_cpu, batch_cpu) = runs
    if rows != rows_cpu or not all(torch.equal(a.cpu(), b)
                                   for a, b in zip(batch, batch_cpu)):
        raise AssertionError("the card's and the CPU's batches differ")
    for steps, tol in ((1, STEP_TOL), (train.local_steps, UPDATE_TOL)):
        def update(adapter, batch, start):
            return params_to_numpy(make_batched_client_update(
                adapter, local_steps=steps, lr=train.client_lr)(
                    params_from_numpy(start, adapter.device),
                    tuple(b[:, :steps] for b in batch)))

        got, want = (update(adapter, batch, params)
                     for adapter, _, batch in runs)
        err = tree_map(lambda a, b: float(abs(a - b).max()), got, want)
        # each device's own spread: its parameters moved by one rounding
        # (the same nudge on both), against its own update unnudged
        r = np.random.default_rng(0)
        nudged = tree_map(lambda a: (a * (1 + 1e-7 * r.standard_normal(
            a.shape))).astype(a.dtype), params)
        spread, card_spread = (max(float(abs(a - b).max()) for a, b in zip(
            tree_leaves(update(adapter, b_, nudged)), tree_leaves(ref)))
            for adapter, b_, ref in ((cpu, batch_cpu, want),
                                     (card, batch, got)))
        print(f"client update ({len(rows)} satellites, {steps} steps): "
              f"max |card - CPU| per leaf {json.dumps(err)}, tolerance "
              f"rtol {tol}, atol {tol}; the spread under a 1e-7 relative "
              f"nudge: CPU {spread}, card {card_spread}", flush=True)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if a.shape != b.shape or not np.allclose(a, b, rtol=tol,
                                                     atol=tol):
                raise AssertionError(f"client update of {steps} steps "
                                     f"differs beyond tolerance")


def _tc_ptxas(log: str):
    """The tensor-core kernels' registers and spills (forward; backward
    delta, dk/dv and dq), one line per instantiation (hd, and for dk/dv
    and dq whether P and dS are split), from ptxas's report; fails on a
    spill (a reused library has no report, and nothing is checked)."""
    import re
    # a mangled name: <length><name>I<template arguments>E
    found = re.findall(r"Compiling entry function '\w*?\d(flash_\w+?_kernel)"
                       r"ILi(\d+)E(?:Lb(\d)E)?E.*?(\d+) bytes spill "
                       r"stores, (\d+) bytes spill loads.*?Used (\d+) "
                       r"registers", log, re.S)
    for kernel, hd, split, stores, loads, regs in found:
        what = f"{kernel} hd {hd}" + (f" split {split}" if split else "")
        print(f"{what}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads", flush=True)
        if int(stores) or int(loads):
            raise AssertionError(f"{what} spills")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.agg import kernel as agg_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel

    t_start = time.perf_counter()

    def done(phase):
        print(f"chip_smoke: {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(smi.splitlines()[0], flush=True)      # name, power limit

    # 2. build, all sources at once
    for b in build.build([agg_kernel.SOURCE, rms_kernel.SOURCE,
                          flash_kernel.SOURCE, flash_kernel.SOURCE_TC,
                          flash_kernel.SOURCE_BWD_TC]):
        print(f"built {b.source.relative_to(ROOT)} -> "
              f"{b.library.relative_to(ROOT)} in {b.seconds:.1f} s",
              flush=True)
        print(b.log.strip(), flush=True)
        if b.source in (flash_kernel.SOURCE_TC, flash_kernel.SOURCE_BWD_TC):
            _tc_ptxas(b.log)
    done("build")

    # 3. kernels against their plain versions
    agg_rows = check_aggregation(torch)
    rms_rows = check_rmsnorm(torch)
    flash_rows = check_flash(torch)
    done("kernel checks")

    # 4, 5. the main paths
    paths = {"quickstart": run_main_path(torch)}
    done("quickstart path")
    paths["transformer"] = run_transformer_path(torch)
    done("transformer path")

    # 6. the kernels line. One aggregation of the quickstart (the four
    # leaves at M=20, float32); one SGD step of a 20-satellite group on
    # the transformer path (5 RMSNorm and 2 attention calls, each way).
    def launches(kernel_name):
        return {p: c.get(kernel_name, 0) for p, c in paths.items()}

    work = [r for r in agg_rows if r["n"] in QUICKSTART_LEAVES
            and r["m"] == MAIN_PATH_M and r["updates"] == "float32"]
    kernels = [{
        "name": agg_kernel.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/agg/csrc/agg.cu",
        "replaces": "src/repro/kernels/agg/kernel.py:35",
        "launches": sum(launches(agg_kernel.NAME).values()),
        "launches_by_path": launches(agg_kernel.NAME),
        "max_abs_err": max(r["max_abs_err"] for r in agg_rows),
        "ms": sum(r["kernel_ms"] for r in work),
        "plain_ms": sum(r["plain_ms"] for r in work),
        "bound_ms": sum(r["bound_ms"] for r in work),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in work)
                    else "operations",
        "library_ms": sum(r["library_ms"] for r in work),
        "work": "one quickstart aggregation: leaves N=1536,48,2976,62 at "
                "M=20, float32",
    }]
    path_shapes = (
        (rms_rows, "rmsnorm", 5, "src/repro_torch/kernels/rmsnorm/csrc/"
         "rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:28",
         lambda r: (r["G"], r["R"], r["D"]) == RMS_PATH
         and r["dtype"] == "float32" and r["x_offset"] == 0,
         f"one SGD step of a 20-satellite group: 5 calls at (G, R, D) = "
         f"{RMS_PATH}, float32; no one PyTorch call takes a scale row per "
         f"satellite"),
        (flash_rows, "flash_attention", 2, "src/repro_torch/kernels/"
         "flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:91",
         lambda r: (r["B"], r["H"], r["K"], r["Sq"], r["Sk"], r["hd"],
                    r["causal"], r["window"], r["dtype"]) == FLASH_PATH,
         "one SGD step of a 20-satellite group: 2 calls at (B, H, K, S, hd)"
         " = (640, 4, 2, 8, 8), causal, float32"))
    for rows, base, calls, source, replaces, at_path, what in path_shapes:
        for kname in (base, base + "_bwd"):
            mine = [r for r in rows if r["kernel"] == kname]
            (r,) = [r for r in mine if at_path(r)]
            kernels.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches(kname).values()),
                "launches_by_path": launches(kname),
                "max_abs_err": max(x["max_abs_err"] for x in mine),
                "ms": calls * r["kernel_ms"],
                "plain_ms": calls * r["plain_ms"],
                "bound_ms": calls * r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": (calls * r["library_ms"]
                               if r["library_ms"] is not None else None),
                "work": what,
            })
    for kname, tc_name in ((flash_kernel.NAME, flash_kernel.NAME_TC),
                           (flash_kernel.NAME_BWD,
                            flash_kernel.NAME_BWD_TC)):
        entry = next(k for k in kernels if k["name"] == kname)
        entry["launches_tc"] = sum(launches(tc_name).values())
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on a main "
                                 f"path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
