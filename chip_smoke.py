#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit) when it fails:
  1. device: the card's name, count, and `nvidia-smi` name/power limit;
  2. build: every CUDA source of the port (aggregation, RMSNorm, flash
     attention on the CUDA cores, its forward and its backward on the
     tensor cores) built with nvcc for sm_90a, one nvcc per source, all
     started together, with ptxas's report (and a summary of the
     tensor-core, short-sequence and aggregation kernels' registers and
     spills, which must be none);
  3. kernels against their plain PyTorch versions, forward and backward,
     at the main paths' shapes, the reference's test sweeps and one large
     shape each, with CUDA-event timings (kernel, plain version, one-call
     library yardstick) beside the least time the card could take for the
     same work; for the aggregation both designs (register, ring) at
     every shape, on permuted rows of a wider buffer, held to each other
     bit for bit, then timed against each other around the cut-off, and
     the ring's stages and tile bytes swept at the paper's size; for
     RMSNorm also the device and host time of a call and
     its kernels per call, two backward calls compared bit for bit, the
     other layouts' times at the zoo shape, and the host cost of the
     pieces of a wrapper call; for attention the route (tensor cores or
     CUDA cores) of both directions on every row, checked against the
     launch counts, the tensor-core backward's errors with P and dS in one
     bf16 part and in two, and at the path's and the zoo shape the device
     and host time of a call and its kernels per call (the zoo forward
     one tensor-core kernel, its backward three, each timed), with the
     CUDA-core route's time on the zoo inputs beside them; every row that
     takes the short-sequence kernels (`short_fits`: the path's training
     and evaluation calls and a sweep at S = 8 and 32) has its device and
     host time, one kernel a call either way, and the older CUDA-core
     kernels' time on the same inputs (their device time too at the
     path's shapes); then one attention call of the path as the adapter
     makes it, traced: the two short kernels and no copy;
  4. the quickstart path: the FedBuff federation of examples/quickstart.py
     (MLP payload) through `Federation.from_experiment(exp).run()` on the
     card, launch counts read around it (one aggregation launch per
     aggregation), then the same experiment on the CPU as the check;
  5. the transformer path: the same FedBuff world with the transformer
     payload (RMSNorm and attention in the kernels, forward and backward)
     on the card, launch counts read around it, then on the CPU, and one
     batched client update of 20 satellites held leaf by leaf against the
     CPU's from the same parameters and batches, beside the spread of the
     CPU's and of the card's own update under a 1e-7 nudge; every
     attention call on the short-sequence kernels; and that client update
     traced (kernels, copy kernels and device time per SGD step, the
     step's wall and the device's busy share); then, in a fresh process
     (`scripts/trace_aggregation.py`), aggregations of both paths traced
     (`aggregation trace`: kernels, copy kernels, device and host
     microseconds from the last client update to the new params);
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
# The flat models one aggregation launch covers (`FlatLayout`: leaves on
# 16 bytes): the quickstart MLP, F=32 -> 48 -> 62 (4,622 parameters, no
# gaps), and the transformer payload (20,766 parameters in 20,768).
QUICKSTART_N = 4_622
TRANSFORMER_N = 20_768
PAPER_N = 26_608_958                       # DenseNet-161, 62-class head
PAPER_M = 191                              # flock191 satellites
MAIN_PATH_M = 20                           # fedbuff M of the quickstart
AGG_TOL = 2e-5      # float32 outputs: the same products summed in another
                    # order (the float32 tolerance of tests/test_kernels.py)
# The register design against the ring around the cut-off
# (`kernel.py::RING_MIN_N`), and the ring's stages and tile bytes a row at
# the paper's size.
AGG_CUTOFF_N = (65_536, 262_144, 1_048_576, 4_194_304, 8_388_608,
                16_777_216, PAPER_N)
AGG_STAGES = (2, 3, 4, 6, 8, 12)
AGG_TILES = (8192, 16384, 32768)


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
    """Least time for one aggregation: every input (M rows of updates,
    params, M weights and M row indices) read once, the output written
    once, against 2*M*N float32 operations."""
    return _bound((m * upd_bytes + 2 * par_bytes) * n + 8 * m, 2 * m * n,
                  FP32_FLOP_PER_S)


def _agg_inputs(torch, g, m, n, udt):
    """M update rows, permuted, in a buffer of M + 3 rows 64 elements
    apart (as the engine's), float32 params, normalised weights, and the
    weights scattered onto the buffer's rows (for `addmv`)."""
    ld = -(-n // 64) * 64
    buf = torch.randn(m + 3, ld, generator=g, device="cuda").to(udt)
    rows = torch.randperm(m + 3, generator=g, device="cuda")[:m].int()
    p = torch.randn(n, generator=g, device="cuda")
    w = torch.rand(m, generator=g, device="cuda")
    w /= w.sum()
    w_rows = torch.zeros(m + 3, device="cuda").index_put_((rows.long(),), w)
    return buf[:, :n], rows, p, w, w_rows


def _both_designs(torch, K, p, upd, w, rows, iters, **ring):
    """The register design's and the ring's outputs (asserted bit-equal)
    and their times."""
    outs, ms = {}, {}
    for design in K.DESIGNS:
        kw = dict(ring) if design == "ring" else {}
        outs[design] = K.weighted_aggregate(p, upd, w, rows, design=design,
                                            **kw)
        ms[design] = _time_ms(lambda: K.weighted_aggregate(
            p, upd, w, rows, design=design, **kw), iters)
    torch.cuda.synchronize()
    if not torch.equal(outs["register"], outs["ring"]):
        raise AssertionError(f"the register design and the ring differ "
                             f"({ring})")
    return outs["register"], ms


def check_aggregation(torch):
    """Phase 3: the agg kernel's two designs against each other (to the
    bit) and against the plain version, on permuted rows of a wider
    buffer, at the main paths' flat models and the paper's size; then
    the two designs around the cut-off, and the ring's stages and tiles
    at the paper's size."""
    from repro_torch.kernels.agg import kernel as K
    from repro_torch.kernels.agg.ref import weighted_aggregate_ref
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(m, n) for n in (QUICKSTART_N, TRANSFORMER_N)
              for m in (1, MAIN_PATH_M, 40)] + [(PAPER_M, PAPER_N)]
    rows_out = []
    for m, n in shapes:
        for udt in (torch.float32, torch.bfloat16):
            upd, rows, p, w, w_rows = _agg_inputs(torch, g, m, n, udt)
            iters = 10 if n == PAPER_N else 200
            out, ms = _both_designs(torch, K, p, upd, w, rows, iters)
            ref = weighted_aggregate_ref(p, upd, w, rows)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = bool(torch.allclose(out, ref, rtol=AGG_TOL, atol=AGG_TOL))
            p_ms = _time_ms(lambda: weighted_aggregate_ref(p, upd, w, rows),
                            iters)
            # one PyTorch call computing the same function (a cuBLAS gemv
            # over the whole buffer, the weights on the rows they name);
            # none takes bfloat16 updates into float32 params
            lib_ms = _time_ms(lambda: torch.addmv(p, upd.t(), w_rows),
                              iters) if udt == torch.float32 else None
            bound, by = _agg_bound(m, n, upd.element_size())
            design = K.design_for(n, upd.stride(0) * upd.element_size())
            row = {"m": m, "n": n, "updates": str(udt).split(".")[-1],
                   "max_abs_err": err, "tol": AGG_TOL, "design": design,
                   "kernel_ms": ms[design], "register_ms": ms["register"],
                   "ring_ms": ms["ring"], "plain_ms": p_ms,
                   "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                   "bound_share": bound / ms[design],
                   "register_share": bound / ms["register"],
                   "ring_share": bound / ms["ring"]}
            print("agg", json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"agg kernel disagrees with its plain "
                                     f"version at {row}")
            rows_out.append(row)
            del upd, rows, p, w, w_rows, out, ref
            torch.cuda.empty_cache()
    for m in (MAIN_PATH_M, PAPER_M):
        for n in AGG_CUTOFF_N:
            upd, rows, p, w, _ = _agg_inputs(torch, g, m, n, torch.float32)
            _, ms = _both_designs(torch, K, p, upd, w, rows, 50)
            print("agg cutoff", json.dumps({
                "m": m, "n": n, "updates": "float32",
                "register_ms": ms["register"], "ring_ms": ms["ring"],
                "bound_ms": _agg_bound(m, n, 4)[0]}), flush=True)
            del upd, rows, p, w
    for udt in (torch.float32, torch.bfloat16):
        # the first version's layout: rows N apart, N % 4 = 2, so the
        # register design takes its one-column-a-thread instantiation
        upd = torch.randn(PAPER_M, PAPER_N, generator=g, device="cuda").to(
            udt)
        p = torch.randn(PAPER_N, generator=g, device="cuda")
        w = torch.full((PAPER_M,), 1 / PAPER_M, device="cuda")
        print("agg unpadded", json.dumps({
            "updates": str(udt).split(".")[-1], "row_stride": PAPER_N,
            "register_ms": _time_ms(lambda: K.weighted_aggregate(
                p, upd, w, design="register"), 10)}), flush=True)
        del upd, p, w
        torch.cuda.empty_cache()
        upd, rows, p, w, _ = _agg_inputs(torch, g, PAPER_M, PAPER_N, udt)
        bound = _agg_bound(PAPER_M, PAPER_N, upd.element_size())[0]
        for tile in AGG_TILES:
            for stages in AGG_STAGES:
                if not K.ring_fits(stages, tile):
                    continue
                _, ms = _both_designs(torch, K, p, upd, w, rows, 5,
                                      stages=stages, tile_bytes=tile)
                print("agg sweep", json.dumps({
                    "updates": str(udt).split(".")[-1], "stages": stages,
                    "tile_bytes": tile, "ring_ms": ms["ring"],
                    "bound_share": bound / ms["ring"]}), flush=True)
        del upd, rows, p, w
        torch.cuda.empty_cache()
    return rows_out


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


def _device_events(prof):
    """(name, count, device us) of each kernel or copy the profiler saw on
    the device (host ops also report the device time of what they
    launched, and are left out)."""
    out = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0) if t is None else t
        if t > 0:
            out.append((e.key, e.count, t))
    return out


def _host_and_device(fn, iters):
    """Per call of `fn`: host microseconds (host clock over `iters` calls,
    no synchronising inside); device microseconds per kernel and kernels
    launched per call, from `torch.profiler`'s `key_averages()` over
    `iters` calls; the names of the kernels seen; and the kernel events
    the profiler recorded. On the H100 machines the profiler drops some
    kernel events (1 to 39 of 200 in a few runs), never adds any, and in
    one run recorded none in a window of 50 calls: the kernels per call are
    the events over the calls rounded up, the device time per call the
    device time per event times that, and a window with no device event is
    traced again, three times at most. Also each kernel's device
    microseconds per event, by name."""
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
    seen = []
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = _device_events(prof)
        if seen:
            break
    if not seen:
        raise AssertionError("torch.profiler shows no device time")
    dev_us = sum(t for _, _, t in seen)
    events = sum(c for _, c, _ in seen)
    names = [n for n, _, _ in seen]
    by_name = {n: t / c for n, c, t in seen}
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
# over 2 kv heads, 8 tokens, hd 8) and evaluation call (1000 samples), a
# short sweep for the short-sequence kernels (the GQA x mask cases at S = 8
# and 32, hd 8, a client batch of 32, f32 and bf16; at S = 32 the unit of 8
# heads over 1 is past `SHORT_BUDGET` and takes the older CUDA-core
# kernels), the short kernels' wider instantiations (padded hd 32, 64,
# 128 and 256 at S = 8, in float32, and in bfloat16 where the route is the
# CUDA cores', hd 32 and 256), the two sweeps of tests/test_kernels.py
# (GQA x mask at S=128, hd=64, in float32 and in bfloat16, the tensor
# cores' route; Sq/Sk x dtype at hd=128, unmasked), head dims the kernels
# do not instantiate (80 in bfloat16, padded to 128 on the tensor cores;
# 12 in float32, padded to 16 on the CUDA cores; 300 in bfloat16 with a
# window of 3 and 1,000 in float32, padded to 512 and 1,024 for the CUDA
# cores' row-looping kernels), and qwen3-8b's head layout at S=2048
# (configs/qwen3_8b.py).
FLASH_PATH = (640, 4, 2, 8, 8, 8, True, 0, "float32")
FLASH_EVAL = (1000, 4, 2, 8, 8, 8, True, 0, "float32")
FLASH_ZOO = (1, 32, 8, 2048, 2048, 128, True, 0, "bfloat16")
FLASH_SHORT_SWEEP = [(32, h, k, s, s, 8, causal, window, dt)
                     for s in (8, 32) for dt in ("float32", "bfloat16")
                     for h, k in ((4, 4), (4, 2), (8, 1))
                     for causal, window in ((True, 0), (True, 3),
                                            (False, 0))]
FLASH_SHORT_WIDE = [(32, 4, 2, 8, 8, hd, True, 0, dt) for hd, dt in (
    (32, "float32"), (32, "bfloat16"), (64, "float32"), (128, "float32"))] + [
    (32, 2, 2, 8, 8, 256, True, 0, dt) for dt in ("float32", "bfloat16")]
FLASH_SHAPES = [FLASH_PATH, FLASH_EVAL] + FLASH_SHORT_SWEEP \
    + FLASH_SHORT_WIDE + [
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
SHORT_KERNELS = {"fwd": "flash_fwd_short_kernel",   # in the short-sequence
                 "bwd": "flash_bwd_short_kernel"}   # kernels' names


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


def _short_row(K, row, tag, direction, kern, iters, q, k, v, o, lse, do,
               kw, fwd_ref, grads_ref, dt):
    """A row of the short-sequence kernels: their device and host time per
    call (one kernel a call, either direction, checked), and the older
    CUDA-core kernels on the same inputs through their C entry points (not
    counted), checked against the plain version and timed, with their
    device time and kernels per call."""
    host_us, dev_us, per_call, names, events, by_name = _host_and_device(
        kern, iters)
    if per_call != 1 or len(names) != 1 or \
            SHORT_KERNELS[direction] not in names[0]:
        raise AssertionError(f"{tag} {direction}: {per_call} kernels per "
                             f"call ({names}), not one short kernel")
    row.update(device_us=dev_us, host_us=host_us, launches_per_call=per_call,
               kernels_seen=names, device_us_by_kernel=by_name,
               profiled=f"{events} kernel events over {iters} calls")
    causal, window = kw["causal"], kw["window"]
    if direction == "fwd":
        def old():
            return _cuda_core_fwd(K, q, k, v, causal, window)
        _compare(tag + " cuda-core", old()[:1], fwd_ref[:1], dt)
    else:
        def old():
            return _bwd_direct(K, q, k, v, o, lse, do, causal, window)
        _compare(tag + " bwd cuda-core", old(), grads_ref, dt, grad=True)
    row["cuda_core_ms"] = _time_ms(old, iters)
    _, dev_old, per_old, _, _, by_old = _host_and_device(old, iters)
    row.update(cuda_core_device_us=dev_old,
               cuda_core_launches_per_call=per_old,
               cuda_core_device_us_by_kernel=by_old)


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
        short = K.short_fits(H // KH, sq, sk, K.padded_head_dim(hd), dt)
        before = dict(launch_counts)
        o, lse = K.flash_attention(q, k, v, **kw)
        o_ref, lse_ref = attention_fwd_ref(q, k, v, **kw)
        grads = K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        for name, want in ((K.NAME_TC, route == "tc"),
                           (K.NAME_BWD_TC, route == "tc"),
                           (K.NAME_SHORT, short), (K.NAME_BWD_SHORT, short)):
            if launch_counts[name] - before.get(name, 0) != want:
                raise AssertionError(f"{shape}: route {route}, short "
                                     f"{short}, but {launch_counts[name]} "
                                     f"{name} launches")
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
        iters = 10 if big else 50 if shape in (
            FLASH_SHORT_SWEEP + FLASH_SHORT_WIDE) else 100
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
                   "route": "short" if short else route, "max_abs_err": err,
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
            if short:
                _short_row(K, row, tag, direction, kern, iters, q, k, v, o,
                           lse, do, kw, (o_ref, lse_ref), grads_ref, dt)
            if shape in (FLASH_PATH, FLASH_ZOO) and not short:
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
    _one_launch_per_aggregation(res, counts)
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


def _one_launch_per_aggregation(res, counts):
    updates = res.num_global_updates
    if updates == 0 or counts.get("weighted_aggregate") != updates:
        raise AssertionError(f"expected one agg launch per aggregation "
                             f"({updates} aggregations), got {counts}")


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
    _one_launch_per_aggregation(res, counts)
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
    # ... and, at S = 8, the short-sequence kernels: every call, both ways
    if counts.get("flash_attention_short", 0) != fa or counts.get(
            "flash_attention_bwd_short", 0) != fb:
        raise AssertionError(f"attention calls that did not take the "
                             f"short-sequence kernels: {counts}")
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
    step = trace_client_update(torch, fed.adapter, exp.train)
    print("client step", json.dumps(step), flush=True)
    return counts


def trace_aggregations_apart():
    """`trace_aggregation` on both paths in a fresh process
    (`scripts/trace_aggregation.py`): in this one, after the profiler
    windows above, the profiler records few device events or none. Prints
    one `aggregation trace` line a path; fails if the script fails, if an
    aggregation ran more than one aggregation kernel, or if a cat or a
    gather ran (a dropped event can only lower these counts)."""
    out = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "trace_aggregation.py"),
                          "--label", "chip_smoke"], capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"scripts/trace_aggregation.py failed:\n"
                             f"{out.stderr[-3000:]}")
    traced = json.loads(out.stdout.strip().splitlines()[-1])
    for exp in (quickstart_experiment(), transformer_experiment()):
        t = traced[exp.name]
        print("aggregation trace", json.dumps(t), flush=True)
        if t["agg_kernels"] > 1 or t["cat_gather_kernels"]:
            raise AssertionError(f"an aggregation of {exp.name} ran "
                                 f"{t['agg_kernels']} aggregation kernels "
                                 f"and {t['cat_gather_kernels']} cats or "
                                 f"gathers")


def _is_copy(name):
    return "copy" in name.lower()


def _is_copy_kernel(name):
    """A kernel that moves data (a copy, a `torch.cat`, a gather or
    indexing), not a host-device transfer."""
    low = name.lower()
    return "memcpy" not in low and any(
        w in low for w in ("copy", "gather", "index"))


def trace_aggregation(torch, exp, traced=3):
    """The federation of `exp` on the card, stopped once `traced`
    aggregations were traced and as many timed. For each aggregation the
    window from the end of its last batched client update
    (`SimulationEngine._run_batched`) to the new params (the engine's next
    call, `SS.aggregate_step`): the host microseconds of the untraced ones
    after the first (host clock ending in a synchronise), and, traced with
    `torch.profiler` (every other one), its device kernels by name, the
    aggregation kernels, the copy kernels (copies, dtype casts, cats,
    gathers), the cat and gather kernels among them, the host-to-device
    transfers and the device microseconds. The profiler on the H100
    machines drops kernel events, most after other profiler windows in
    the same process, and now and then records none: a window without a
    device event is traced again, and the counts are a floor. It hooks
    only `_run_batched` and the engine module's `SS`, so it runs on any
    checkout of the port (`scripts/trace_aggregation.py`)."""
    from repro_torch.fl import engine as E
    from repro_torch.fl.api import Federation
    eng = Federation.from_experiment(exp).engine()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    st = {"prof": None, "t0": None, "n": 0}
    host_us, traces = [], []
    run_batched = eng._run_batched

    def hooked_run(*args, **kw):
        if st["prof"] is not None:      # not the aggregation's last group
            st["prof"].stop()
            st["prof"] = None
        out = run_batched(*args, **kw)
        torch.cuda.synchronize()
        if st["n"] % 2:
            st["prof"] = torch.profiler.profile(activities=acts)
            st["prof"].start()
        st["t0"] = time.perf_counter()
        return out

    real = E.SS

    class _Hooked:
        def __getattr__(self, name):
            return getattr(real, name)

        def aggregate_step(self, *args, **kw):
            torch.cuda.synchronize()
            us = (time.perf_counter() - st["t0"]) * 1e6
            if st["prof"] is not None:
                st["prof"].stop()
                events = _device_events(st["prof"])
                if events:
                    traces.append(events)
                st["prof"] = None
            elif st["n"]:
                host_us.append(us)
            st["n"] += 1
            if len(traces) >= traced and len(host_us) >= traced \
                    or st["n"] > 6 * traced:
                eng.request_stop()
            return real.aggregate_step(*args, **kw)

    eng._run_batched = hooked_run
    E.SS = _Hooked()
    try:
        eng.run()
    finally:
        E.SS = real
    if len(traces) < traced:
        raise AssertionError(f"{len(traces)} of the traced aggregations "
                             f"showed device events, not {traced}")
    per = 1 / len(traces)
    by_name = {}
    for events in traces:
        for n, c, _ in events:
            by_name[n[:120]] = by_name.get(n[:120], 0) + c * per
    return {"experiment": exp.name, "aggregations_traced": len(traces),
            "host_us": host_us,
            "kernels": sum(c for ev in traces for _, c, _ in ev) * per,
            "agg_kernels": sum(c for ev in traces for n, c, _ in ev
                               if "agg_" in n) * per,
            "copy_kernels": sum(c for ev in traces for n, c, _ in ev
                                if _is_copy_kernel(n)) * per,
            "cat_gather_kernels": sum(
                c for ev in traces for n, c, _ in ev
                if any(w in n.lower() for w in ("catarray", "gather",
                                                "index"))) * per,
            "host_to_device": sum(c for ev in traces for n, c, _ in ev
                                  if "memcpy" in n.lower()) * per,
            "device_us": [sum(t for _, _, t in ev) for ev in traces],
            "by_name": by_name}


def trace_client_update(torch, adapter, train, runs=5):
    """One batched client update of the transformer path (the first 20
    satellites, `local_steps` SGD steps at the path's lr), traced with
    `torch.profiler` after a warm-up: kernels, copy kernels and device
    microseconds per SGD step, and the wall of a step from `runs` untraced
    updates (host clock, ending in a synchronise), with the busy share
    (device time over wall). The profiler drops a few kernel events on the
    H100 machines, so the kernel counts are a floor."""
    from repro_torch.fl.client import make_batched_client_update
    params = adapter.init(torch.Generator().manual_seed(0))
    batch, _ = adapter.client_batch_many(list(range(MAIN_PATH_M)), 0,
                                         train.batch_size, train.local_steps)
    update = make_batched_client_update(adapter, local_steps=train.local_steps,
                                        lr=train.client_lr)
    batch = tuple(batch)
    update(params, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        update(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / train.local_steps * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        update(params, batch)
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise AssertionError("torch.profiler shows no device time")
    steps = train.local_steps
    dev_us = sum(t for _, _, t in events) / steps
    wall_ms = sorted(walls)[len(walls) // 2]
    return {"satellites": MAIN_PATH_M, "sgd_steps": steps,
            "kernels_per_step": sum(c for _, c, _ in events) / steps,
            "copy_kernels_per_step": sum(c for n, c, _ in events
                                         if _is_copy(n)) / steps,
            "device_us_per_step": dev_us, "wall_ms_per_step": walls,
            "busy_share": dev_us / (wall_ms * 1e3),
            "kernels_by_name": {n[:120]: c for n, c, _ in sorted(
                events, key=lambda e: -e[1])}}


def trace_attention_call(torch, iters=200):
    """The transformer path's attention call as its adapter makes it, one
    forward and one backward of `ops.flash_attention_bshd` on (B, S, H, hd)
    projections, o read as (B, S, H * hd) and the cotangent given so: the
    host microseconds of a forward (recording the graph), of a forward
    and backward, and of the (B, H, S, hd) wrappers' forward and backward
    calls on the same values (host clock over `iters` calls, no
    synchronising inside), then, traced, the device kernels the path's
    call runs, by name, per call."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
    B, H, KH, S, _, hd = FLASH_PATH[:6]
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(B, S, 32, generator=g, device="cuda")
    w = [torch.randn(32, n * hd, generator=g, device="cuda")
         for n in (H, KH, KH)]
    do = torch.randn(B, S, H * hd, generator=g, device="cuda")
    # the projections are made outside the traced window
    inputs = [(x @ wi).reshape(B, S, -1, hd) for wi in w]

    def call():
        q, k, v = (t.detach().requires_grad_() for t in inputs)
        o = flash_attention_bshd(q, k, v, causal=True).reshape(B, S, H * hd)
        return torch.autograd.grad(o, (q, k, v), do)

    def forward():
        q, k, v = (t.detach().requires_grad_() for t in inputs)
        return flash_attention_bshd(q, k, v, causal=True)
    bhsd = [t.transpose(1, 2).contiguous() for t in inputs]
    o, lse = K.flash_attention(*bhsd)
    do_bhsd = do.view(B, S, H, hd).transpose(1, 2).contiguous()
    host_us = {}
    for name, fn in (
            ("forward", forward), ("forward and backward", call),
            ("wrapper forward (B, H, S, hd)", lambda: K.flash_attention(
                *bhsd)),
            ("wrapper backward (B, H, S, hd)", lambda: K.flash_attention_bwd(
                *bhsd, o, lse, do_bhsd))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us[name] = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced = 20
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            call()
        torch.cuda.synchronize()
    events = _device_events(prof)
    return {"host_us": host_us, "calls": traced,
            "kernels_per_call": {n[:120]: c / traced for n, c, _ in events},
            "copy_kernels_per_call": sum(c for n, c, _ in events
                                         if _is_copy(n)) / traced}


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


# ptxas's report of a kernel, from its mangled name - <length><name>I<template
# arguments>E - to its registers: the tensor-core kernels (hd, and for dk/dv
# and dq whether P and dS are split) and the short-sequence kernels (type,
# hd)
PTXAS_ENTRY = (r"Compiling entry function '\w*?\d({})I{}E.*?(\d+) bytes "
               r"spill stores, (\d+) bytes spill loads.*?Used (\d+) "
               r"registers")
PTXAS_KERNELS = {"tc": (r"flash_\w+?_tc_\w*?kernel",
                        r"Li(\d+)E(?:Lb(\d)E)?"),
                 "short": (r"flash_(?:fwd|bwd)_short_kernel",
                           r"(f|13__nv_bfloat16)Li(\d+)E"),
                 "agg": (r"agg_(?:register|ring)_kernel",
                         r"((?:f|13__nv_bfloat16)(?:f|13__nv_bfloat16|S1_))"
                         r"(?:Li(\d)E)?")}
SHORT_INSTANCES = 2 * 2 * 6    # directions x types x head dims
AGG_INSTANCES = 4 * 3          # type pairs x (register 4- and 1-wide, ring)


def _ptxas(log: str, kind: str):
    """The registers and spills of the tensor-core kernels (forward;
    backward delta, dk/dv and dq), of the short-sequence kernels (both
    directions, every type and hd) or of the aggregation's (both designs,
    every type pair), one line per instantiation, from ptxas's report;
    fails on a spill, and, for the short and the aggregation kernels,
    unless every instantiation is reported (a reused library has no
    report, and nothing is checked)."""
    import re
    found = re.findall(PTXAS_ENTRY.format(*PTXAS_KERNELS[kind]), log,
                       re.S)
    for kernel, a, b, stores, loads, regs in found:
        if kind == "tc":
            what = f"{kernel} hd {a}" + (f" split {b}" if b else "")
        elif kind == "short":
            what = f"{kernel} {'bf16' if 'bfloat16' in a else 'f32'} hd {b}"
        else:
            what = f"{kernel} <{a}>" + (f" E {b}" if b else "")
        print(f"{what}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads", flush=True)
        if int(stores) or int(loads):
            raise AssertionError(f"{what} spills")
    want = {"short": SHORT_INSTANCES, "agg": AGG_INSTANCES}.get(kind)
    if want and "Compiling entry function" in log and len(found) != want:
        raise AssertionError(f"ptxas reported {len(found)} {kind} "
                             f"kernels, not {want}")


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
            _ptxas(b.log, "tc")
        if b.source == flash_kernel.SOURCE:
            _ptxas(b.log, "short")
        if b.source == agg_kernel.SOURCE:
            _ptxas(b.log, "agg")
    done("build")

    # 3. kernels against their plain versions
    agg_rows = check_aggregation(torch)
    rms_rows = check_rmsnorm(torch)
    flash_rows = check_flash(torch)
    call = trace_attention_call(torch)
    print("attention call", json.dumps(call), flush=True)
    seen = call["kernels_per_call"]
    if call["copy_kernels_per_call"] or len(seen) != 2 or not all(
            any(name in n for n in seen) for name in SHORT_KERNELS.values()):
        raise AssertionError(f"the path's attention call ran {seen}, not "
                             f"the two short-sequence kernels alone")
    done("kernel checks")

    # 4, 5. the main paths
    paths = {"quickstart": run_main_path(torch)}
    done("quickstart path")
    paths["transformer"] = run_transformer_path(torch)
    done("transformer path")
    trace_aggregations_apart()
    done("aggregation traces")

    # 6. the kernels line. One aggregation of the quickstart (one launch
    # over its flat model at M=20, float32); one SGD step of a
    # 20-satellite group on the transformer path (5 RMSNorm and 2
    # attention calls, each way).
    def launches(kernel_name):
        return {p: c.get(kernel_name, 0) for p, c in paths.items()}

    (r,) = [r for r in agg_rows if r["n"] == QUICKSTART_N
            and r["m"] == MAIN_PATH_M and r["updates"] == "float32"]
    kernels = [{
        "name": agg_kernel.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/agg/csrc/agg.cu",
        "replaces": "src/repro/kernels/agg/kernel.py:35",
        "launches": sum(launches(agg_kernel.NAME).values()),
        "launches_by_path": launches(agg_kernel.NAME),
        "max_abs_err": max(x["max_abs_err"] for x in agg_rows),
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "design": r["design"],
        "work": "one quickstart aggregation: one launch over N = 4,622 at "
                "M = 20, float32",
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
    for kname, tc_name, short_name in (
            (flash_kernel.NAME, flash_kernel.NAME_TC, flash_kernel.NAME_SHORT),
            (flash_kernel.NAME_BWD, flash_kernel.NAME_BWD_TC,
             flash_kernel.NAME_BWD_SHORT)):
        entry = next(k for k in kernels if k["name"] == kname)
        entry["launches_tc"] = sum(launches(tc_name).values())
        entry["launches_short"] = sum(launches(short_name).values())
        # per call at the path's shape: the short kernel's device time and
        # the older CUDA-core kernels' on the same inputs
        (r,) = [r for r in flash_rows if r["kernel"] == kname and (
            r["B"], r["H"], r["K"], r["Sq"], r["Sk"], r["hd"], r["causal"],
            r["window"], r["dtype"]) == FLASH_PATH]
        entry.update(device_us_per_call=r["device_us"],
                     cuda_core_device_us_per_call=r["cuda_core_device_us"],
                     bound_ms_per_call=r["bound_ms"])
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
