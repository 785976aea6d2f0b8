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
     pieces of a wrapper call, and at the path's shape the kernel's and
     the float32 plain version's errors against float64 (`rmsnorm f64`);
     for attention the route (tensor cores or
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
  6. the FedSpace path (`fedspace` lines): (a) the quickstart world under
     FedSpace with a histogram-only forest (no split on the status T)
     through `Federation.from_experiment(exp).run()` on the card, launch
     counts read around it (one aggregation launch per aggregation),
     then on the CPU: counters and every re-plan's schedule equal; (b)
     the quickstart's FedSpace row as a user runs it: phase 1 on the card
     (its seconds, the regressor's in-sample R^2; the eq.-12 samples
     generated twice, bit for bit alike, and the forest refitted on them
     the federation's), the run on the card (wall, days to 35%, counters,
     launches) and on the CPU with the same regressor: counters and
     schedules equal; (c) one re-plan's `score_candidates` timed at the
     quickstart's shape and the paper's (R 5000, K 191), with its device
     events and time;
  7. the DenseNet path (`densenet` lines), Part A of
     examples/satellite_fl_train.py (48 satellites, 2 days, the DenseNet
     adapter's widths with the first block frozen): (a) under FedBuff
     (M 8) on the card, launch counts read around it (one aggregation
     launch per aggregation), then on the CPU from the same initial
     model: counters equal, the frozen leaves bit for bit the initial
     model on both devices, the final models and accuracies as near as
     a one-rounding nudge of the initial model moves the card's own; (b)
     Part A as a user runs it, FedSpace with phase 1 on the card (its
     seconds by part, R^2), the run (wall, counters, launches), then on
     the CPU with the forest carried across: counters and every re-plan's
     schedule equal, or parted only on a forest split on the status T,
     both values printed (ROADMAP C13); (c) one client update at M 8 and
     M 20 held leaf by leaf against the CPU's and repeated bit for bit on
     the card, then traced (`densenet client step`);
  8. the scenarios (`scenarios` lines), link budgets and inter-satellite
     links through the repo's examples: (a) every policy of
     examples/scheduler_comparison.py (starlink40, 384 windows, its
     ISLConfig; the chaos-held async and isl_async over the first 96) on
     the card and on the CPU, FedSpace with phase 1 on the
     card (its seconds) and the forest carried to the CPU; (b) the
     binding cell of examples/isl_comparison.py (starlink40 over sparse1
     under a finite budget; its blocked share): fedbuff, intra_plane,
     isl_async and FedSpace's link-gated search, card against CPU, with
     the final `progress` and `relay` columns; counters, histograms and
     columns equal, FedSpace's re-plans under ROADMAP C13, one
     aggregation launch per aggregation in every run; (c) a re-plan's ms
     with and without the gate;
  9. the fault study (`faults` lines), examples/fault_study.py's world
     (starlink40 over dense12, 192 windows, its budget and ISLs) and its
     five fault worlds: (a) the 15 sweepable cells (sync, fedbuff,
     intra_plane) through `sweep_engines` (the call `run_sweep` makes) on
     the card and on the CPU, every outcome equal, the card's window loops
     under `torch.cuda.set_sync_debug_mode("error")`, groups and walls
     printed, and three cells run one by one through the card's `.run()`,
     equal to the sweep; (b) FedSpace under each fault world and under
     churn40 as an oracle, phase 1 once on the card and the forest carried
     to the CPU, card against CPU as in the scenarios; (c) the traces'
     numbers (alive satellites at the end, contacts and grant units
     removed);
  10. one JSON line listing every ported kernel.
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
DENSENET_N = 12_512                        # Part A's DenseNet, 28 leaves
FAULT_N = 6_144     # the fault study's and the ISL cell's MLP, F=32 -> 64
                    # -> 62 (6,142 parameters)
FAULT_M = 10                               # fedbuff/intra_plane M there
DENSENET_M = 8                             # fedbuff M of the DenseNet path
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
    shapes = [(m, n) for n in (QUICKSTART_N, TRANSFORMER_N, DENSENET_N)
              for m in (1, MAIN_PATH_M, 40)] + [(DENSENET_M, DENSENET_N),
                                                (FAULT_M, FAULT_N),
                                                (MAIN_PATH_M, FAULT_N),
                                                (PAPER_M, PAPER_N)]
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


def _rms_f64_errors(x, scale, dy, kernel, plain):
    """The kernel's and the float32 plain version's errors against the
    function computed in float64 from the same inputs, for y, rstd, dx and
    dscale: `max_rel` is max |err| / max |f64 value|; `bias` is mean(err) /
    mean(|err|), near 0 when the errors are rounding noise of either sign,
    near 1 in size when an order of sums pushes them one way."""
    xd, sd, dyd = x.double(), scale.double()[:, None, :], dy.double()
    rstd = ((xd * xd).mean(-1, keepdim=True) + RMS_EPS).rsqrt()
    xh = xd * rstd
    gy = dyd * sd
    exact = (xh * sd, rstd.reshape(-1),
             rstd * (gy - xh * (gy * xh).mean(-1, keepdim=True)),
             (dyd * xh).sum(-2))
    out = {"shape": list(x.shape), "dtype": str(x.dtype)}
    for name, k, p, e in zip(("y", "rstd", "dx", "dscale"), kernel, plain,
                             exact):
        top = float(e.abs().max())
        row = {}
        for who, got in (("kernel", k), ("plain_f32", p)):
            err = got.double().reshape(e.shape) - e
            row[who + "_max_rel"] = float(err.abs().max()) / top
            mean_abs = float(err.abs().mean())
            row[who + "_bias"] = float(err.mean()) / mean_abs \
                if mean_abs else 0.0
        out[name] = row
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
        if (G, R, D) == RMS_PATH and dts == "float32":
            print("rmsnorm f64", json.dumps(_rms_f64_errors(
                x, scale, dy, (y, rstd, dx, ds),
                (y_ref, rstd_ref, dx_ref, ds_ref))), flush=True)
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


def _trainable_mask(adapter, params):
    """The adapter's frozen-parameter mask, as the engine builds it."""
    return adapter.trainable_mask(params) \
        if hasattr(adapter, "trainable_mask") else None


def trace_client_update(torch, adapter, train, runs=5, m=MAIN_PATH_M):
    """One batched client update of a path (the first `m` satellites,
    `local_steps` SGD steps at the path's lr, with the adapter's mask),
    traced with `torch.profiler` after a warm-up: kernels, copy kernels
    and device microseconds per SGD step (the slowest kernels' by name),
    and the wall of a step from `runs` untraced updates (host clock,
    ending in a synchronise), with the busy share (device time over
    wall). The profiler drops a few kernel events on the H100 machines,
    so the kernel counts are a floor."""
    from repro_torch.fl.client import make_batched_client_update
    params = adapter.init(torch.Generator().manual_seed(0))
    batch, rows = adapter.client_batch_many(list(range(m)), 0,
                                            train.batch_size,
                                            train.local_steps)
    update = make_batched_client_update(
        adapter, local_steps=train.local_steps, lr=train.client_lr,
        trainable_mask=_trainable_mask(adapter, params))
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
    return {"satellites": len(rows), "sgd_steps": steps,
            "kernels_per_step": sum(c for _, c, _ in events) / steps,
            "copy_kernels_per_step": sum(c for n, c, _ in events
                                         if _is_copy(n)) / steps,
            "device_us_per_step": dev_us, "wall_ms_per_step": walls,
            "busy_share": dev_us / (wall_ms * 1e3),
            "kernels_by_name": {n[:120]: c for n, c, _ in sorted(
                events, key=lambda e: -e[1])},
            "device_us_per_step_by_name": {n[:120]: t / steps for n, _, t in
                                           sorted(events,
                                                  key=lambda e: -e[2])[:8]}}


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


def check_client_update(torch, card, cpu, train, m=MAIN_PATH_M,
                        tols=(STEP_TOL, UPDATE_TOL)):
    """A path adapter's batched client update (the first `m` satellites,
    at the path's lr, with the adapter's mask) on the card and on the
    CPU, from the same parameters and batches, compared leaf by leaf
    within `tols` (one step, `local_steps` steps): on the transformer path
    the ops' autograd functions (kernels both ways) against autograd of
    the plain versions. The card's update is run twice and must repeat
    bit for bit. It runs after the path's launch counts were read."""
    import numpy as np
    from repro_torch.fl.client import make_batched_client_update
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import params_from_numpy, params_to_numpy
    params = params_to_numpy(cpu.init(torch.Generator().manual_seed(0)))
    mask = _trainable_mask(cpu, params)
    runs = []
    for adapter in (card, cpu):
        batch, rows = adapter.client_batch_many(
            list(range(m)), 0, train.batch_size, train.local_steps)
        runs.append((adapter, rows, batch))
    (_, rows, batch), (_, rows_cpu, batch_cpu) = runs
    if rows != rows_cpu or not all(torch.equal(a.cpu(), b)
                                   for a, b in zip(batch, batch_cpu)):
        raise AssertionError("the card's and the CPU's batches differ")
    for steps, tol in zip((1, train.local_steps), tols):
        def update(adapter, batch, start):
            return params_to_numpy(make_batched_client_update(
                adapter, local_steps=steps, lr=train.client_lr,
                trainable_mask=mask)(
                    params_from_numpy(start, adapter.device),
                    tuple(b[:, :steps] for b in batch)))

        got, want = (update(adapter, batch, params)
                     for adapter, _, batch in runs)
        again = update(card, batch, params)
        if not all(np.array_equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(again))):
            raise AssertionError(f"two card updates of {steps} steps "
                                 f"differ")
        if mask is not None and any(
                m_ == 0.0 and (a.any() or b.any()) for m_, a, b in zip(
                    tree_leaves(mask), tree_leaves(got), tree_leaves(want))):
            raise AssertionError("a frozen leaf moved")
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
        print(f"client update ({len(rows)} satellites, {steps} steps, "
              f"two card calls bit for bit alike): "
              f"max |card - CPU| per leaf {json.dumps(err)}, tolerance "
              f"rtol {tol}, atol {tol}; the spread under a 1e-7 relative "
              f"nudge: CPU {spread}, card {card_spread}", flush=True)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if a.shape != b.shape or not np.allclose(a, b, rtol=tol,
                                                     atol=tol):
                raise AssertionError(f"client update of {steps} steps "
                                     f"differs beyond tolerance")


# The quickstart's FedSpace row (examples/quickstart.py): the schedule
# search's knobs and phase 1's setup.
FEDSPACE_PARAMS = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 500}
FEDSPACE_SETUP = {"pretrain_rounds": 25, "clients_per_round": 16,
                  "utility_samples": 120, "local_steps": 16,
                  "client_lr": 1.0}
T_FEATURE = 12           # the training status T among the 13 features
C13_BAND = 1e-5          # a forest split on T this near a re-plan's T


def fedspace_experiment(params, setup=None):
    """The quickstart world under FedSpace with `params` (and phase-1
    `setup`)."""
    import dataclasses
    from repro_torch.fl.api import SchedulerConfig
    return dataclasses.replace(
        quickstart_experiment(), name="quickstart-fedspace",
        scheduler=SchedulerConfig(kind="fedspace", params=params,
                                  setup=setup or {}))


class Replans:
    """Records every re-plan of the FedSpace schedulers (global version,
    status T, chosen schedule) by wrapping `search.fedspace_search`, which
    the scheduler calls through its module, while the block runs."""

    def __enter__(self):
        from repro_torch.core import search
        self.log, self._inner = [], search.fedspace_search

        def recording(rng, C_window, state, ig, regressor, status, **kw):
            out = self._inner(rng, C_window, state, ig, regressor, status,
                              **kw)
            self.log.append({"ig": int(ig), "status": float(status),
                             "schedule": out.copy()})
            return out
        search.fedspace_search = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.core import search
        search.fedspace_search = self._inner


def _same_schedules(card, cpu, regressor=None, t_split_ok=False):
    """Every re-plan's schedule equal, card against CPU: returns None. On
    the first difference, print both re-plans (their statuses) and the
    forest threshold on T nearest to them, then fail; with `t_split_ok`
    return that re-plan's index instead when the threshold shows the
    cause (ROADMAP C13): it lies within `C13_BAND` of the re-plan's T on
    either device, or between the two."""
    if len(card) == len(cpu) and all(
            (a["schedule"] == b["schedule"]).all()
            for a, b in zip(card, cpu)):
        return None
    j = next((j for j, (a, b) in enumerate(zip(card, cpu))
              if not (a["schedule"] == b["schedule"]).all()),
             min(len(card), len(cpu)))
    print(f"re-plans: card {len(card)}, CPU {len(cpu)}; first difference "
          f"at re-plan {j}", flush=True)
    for side, log in (("card", card), ("CPU", cpu)):
        if j < len(log):
            print(f"  {side}: ig {log[j]['ig']} status {log[j]['status']!r}"
                  f" schedule {log[j]['schedule'].tolist()}", flush=True)
    if regressor is not None and j < min(len(card), len(cpu)):
        fa = regressor.arrays()
        th = fa.thresh[fa.feature == T_FEATURE]
        st = card[j]["status"]
        near = float(th[abs(th - st).argmin()]) if th.size else None
        print(f"  nearest forest threshold on T: {near!r} "
              f"({th.size} splits on T)", flush=True)
        lo, hi = sorted((st, cpu[j]["status"]))
        cause = th[(th >= lo - C13_BAND) & (th <= hi + C13_BAND)]
        if t_split_ok and cause.size:
            print(f"C13: the schedules part at re-plan {j} on the forest's "
                  f"split at T = {float(cause[0])!r}; the card's T "
                  f"{st!r}, the CPU's {cpu[j]['status']!r}", flush=True)
            return j
    raise AssertionError("FedSpace schedules differ, card against CPU")


def _hist_forest(seed=3, s_max=8, n=400):
    """A forest over staleness histograms whose training features all
    carry status 1.0 (tests/test_hotpath_parity.py's fixture, fitted with
    the port's forest): no split is on T, so a schedule cannot depend on
    the float val loss."""
    import numpy as np
    from repro_torch.core.utility import RandomForestRegressor, featurize
    rng = np.random.default_rng(seed)
    hists = rng.integers(0, 25, (n, s_max + 1)).astype(np.float32)
    X = featurize(hists, 1.0)
    s = np.arange(s_max + 1, dtype=np.float32)
    y = ((hists * (1.2 - 0.3 * s)).sum(1) / np.maximum(hists.sum(1), 1.0)
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    return RandomForestRegressor(n_trees=20, max_depth=6, seed=seed).fit(X, y)


def _fedspace_runs(torch, exp, card_fed, p0, tag):
    """The run on the card (launch counts read around it), then the same
    experiment on the CPU from `p0`; counters, schedules and final
    accuracy compared. Returns (card result, launch counts)."""
    import math
    from repro_torch.fl.api import Federation
    from repro_torch.kernels import launch_counts
    launch_counts.clear()
    t0 = time.perf_counter()
    with Replans() as card:
        res = card_fed.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    print(f"fedspace {tag} (cuda):", json.dumps(res.summary()), flush=True)
    d = res.time_to_target_days
    print(f"fedspace {tag} (cuda): wall {wall:.3f} s, days_to_35%="
          f"{d if d else 'not reached'} updates={res.num_global_updates} "
          f"idle={res.idle_connections}/{res.total_connections} "
          f"staleness_hist={res.staleness_hist.tolist()}, re-plans "
          f"{len(card.log)}, launches {counts}", flush=True)
    _one_launch_per_aggregation(res, counts)
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    t0 = time.perf_counter()
    with Replans() as cpu_log:
        cpu = Federation.from_experiment(exp, device="cpu").run(
            init_params=p0)
    print(f"fedspace {tag} (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    _same_schedules(card.log, cpu_log.log, card_fed.scheduler.regressor)
    print(f"fedspace {tag}: {len(card.log)} re-plans, schedules equal, card"
          f" against CPU", flush=True)
    _close_accuracy(res, cpu, 0.01)
    return res, counts


def run_fedspace_path(torch):
    """Phase 6, the FedSpace path. (a) the quickstart world with a
    histogram-only forest, card against CPU; (b) the quickstart's FedSpace
    row as a user runs it: phase 1 on the card (its samples generated
    twice, bit for bit alike), the run on the card, then on the CPU with
    the same regressor; (c) the re-plan's cost. Returns the launch counts
    of (b)'s card run."""
    import numpy as np
    from repro_torch.core.utility import RandomForestRegressor
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.fl.fedspace_setup import (phase1_samples,
                                               pretrain_trajectory)
    from repro_torch.weights import params_to_numpy

    # (a)
    exp = fedspace_experiment({**FEDSPACE_PARAMS,
                               "regressor": _hist_forest()})
    fed = Federation.from_experiment(exp)
    p0 = params_to_numpy(fed.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    _fedspace_runs(torch, exp, fed, p0, "histogram forest")

    # (b) phase 1 as the quickstart builds it: a FedBuff world, then
    # with_scheduler
    base = Federation.from_experiment(quickstart_experiment())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = base.with_scheduler(SchedulerConfig(
        kind="fedspace", params=FEDSPACE_PARAMS, setup=FEDSPACE_SETUP))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = fs.scheduler_diag
    print(f"fedspace phase 1 (cuda): {secs:.3f} s, regressor R^2="
          f"{d['r2_in_sample']!r} on {d['n']} (s, T) -> dF samples, "
          f"y_mean {d['y_mean']!r}, y_std {d['y_std']!r}", flush=True)
    # phase 1 again, part by part: the samples twice, the forest refitted
    setup, parts = FEDSPACE_SETUP, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    traj = timed("pretrain", lambda: pretrain_trajectory(
        fs.adapter, rounds=setup["pretrain_rounds"],
        clients_per_round=setup["clients_per_round"],
        local_steps=setup["local_steps"], client_lr=setup["client_lr"]))
    kw = dict(n_samples=setup["utility_samples"],
              local_steps=setup["local_steps"],
              client_lr=setup["client_lr"])
    X1, y1 = timed("samples", lambda: phase1_samples(fs.adapter, traj, **kw))
    X2, y2 = timed("samples", lambda: phase1_samples(fs.adapter, traj, **kw))
    if not (np.array_equal(X1, X2) and np.array_equal(y1, y2)):
        raise AssertionError("phase-1 samples differ between two "
                             "generations on the card")
    refit = timed("forest_fit", lambda: RandomForestRegressor(seed=0).fit(
        X1, y1)).arrays()
    fitted = fs.scheduler.regressor.arrays()
    if not all(np.array_equal(getattr(refit, f), getattr(fitted, f))
               for f in ("feature", "thresh", "left", "right", "value")):
        raise AssertionError("phase 1 repeated gives another forest")
    print(f"fedspace phase 1 (cuda): samples ({X1.shape[0]} x "
          f"{X1.shape[1]}) bit for bit alike in two generations, and the "
          f"forest refitted on them is the federation's; seconds by part "
          f"{json.dumps(parts)}", flush=True)
    p0 = params_to_numpy(fs.adapter.init(torch.Generator().manual_seed(
        fs.experiment.seed)))
    row = fedspace_experiment({**FEDSPACE_PARAMS,
                               "regressor": fs.scheduler.regressor})
    res, counts = _fedspace_runs(torch, row, fs, p0, "quickstart row")

    # (c)
    time_replans(torch, fs.scheduler.regressor,
                 res.val_loss[0] if res.val_loss else 4.0)
    return counts


def time_replans(torch, regressor, status):
    """Phase 6 (c): one re-plan's `score_candidates` (CUDA events over a
    few calls, after a warm-up), its device events and device time
    (`torch.profiler`), at the quickstart's shape (R 500, I0 24, K 40)
    and the paper's (R 5000, I0 24, K 191, the flock191 preset), from a
    random mid-run state; and the marks buffer's bytes, R·I0·K int8."""
    import numpy as np
    from repro_torch.core import connectivity as CN
    from repro_torch.core import search as SR
    from repro_torch.core import staleness as SS
    for name, spec, R, iters in (
            ("quickstart", CN.ConstellationSpec(num_satellites=40), 500, 20),
            ("paper", CN.constellation_preset("flock191"), 5000, 10)):
        I0 = FEDSPACE_PARAMS["I0"]
        C = CN.connectivity_sets(spec, days=0.25)[:I0]
        K = C.shape[1]
        r = np.random.default_rng(0)
        ig = 20
        state = SS.SatState(*(torch.as_tensor(
            r.integers(-1, ig + 1, K).astype(np.int32), device="cuda")
            for _ in range(3)))
        cands = SR.random_candidates(r, I0, 4, 8, R)

        def replan():
            return SR.score_candidates(cands, C, state, ig, regressor,
                                       status)
        scores = replan()
        if scores.shape != (R,) or not np.isfinite(scores).all():
            raise AssertionError(f"re-plan scores at {name}: not {R} "
                                 f"finite values")
        ms = _time_ms(replan, iters)
        host_us, dev_us, per_call, _, events, by_name = _host_and_device(
            replan, iters)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        row = {"shape": name, "R": R, "I0": I0, "K": K, "ms": ms,
               "host_us": host_us, "device_us": dev_us,
               "device_events_per_replan": per_call,
               "marks_bytes": R * I0 * K,
               "profiled": f"{events} kernel events over {iters} calls",
               "slowest_kernels_us_per_event": top}
        print("fedspace replan", json.dumps(row), flush=True)


# Part A of examples/satellite_fl_train.py: the paper's model family at the
# DenseNet adapter's own widths (28 leaves, N = 12,512), the first block
# frozen (paper §4.1), 48 satellites over 2 days, 144 windows.
DENSENET_WIDTHS = {"growth": 8, "blocks": (2, 2, 2), "stem": 16,
                   "frozen_blocks": 1}
DENSENET_FEDSPACE = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 300}
DENSENET_SETUP = {"pretrain_rounds": 10, "clients_per_round": 8,
                  "utility_samples": 40, "clients_per_sample": 6,
                  "local_steps": 8, "client_lr": 0.3}
# The card's run against the CPU's is chaotic: a ReLU input that rounds to
# 0 on one device and not on the other switches off that element's
# gradient, and the run's aggregations carry the difference on, as they
# carry a nudge of the initial model by one rounding (1e-7 relative) on
# one device. So the card is held to the CPU against that spread, measured
# on the card in the same call: its final model's drift from the CPU's
# (|a - b| / |b - p0|), and the largest gap between their accuracies, at
# most `CHAOS_FACTOR` times the card's own under the nudge (the
# accuracies also within one argmax flip of 600).
CHAOS_FACTOR = 3.0
# One step and 8 steps of a DenseNet client update at lr 0.3, card against
# CPU: one such ReLU moves a leaf by ~1.4e-4 a step, and 8-20 satellites
# hold many; `check_client_update` prints beside the difference how far
# each device's own update moves when its parameters move by one rounding.
DENSENET_STEP_TOL = 5e-3
DENSENET_UPDATE_TOL = 2e-2


def densenet_experiment(scheduler):
    """Part A's world under `scheduler` (no target accuracy, so the run
    length cannot depend on floats)."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment,
                                    PartitionConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="satellite_fl_densenet",
        constellation=ConstellationConfig(num_satellites=48, days=2.0),
        dataset=DatasetConfig(num_train=3000, num_val=600, image_size=16,
                              noise=1.0),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="densenet", params=DENSENET_WIDTHS),
        scheduler=scheduler,
        train=EngineConfig(local_steps=8, client_lr=0.3, eval_every=24,
                           max_windows=144))


class Phase1Parts:
    """Seconds of FedSpace's phase 1 by part while the block runs (each
    ending in a synchronise): the pretrain, the eq.-12 samples and the
    forest's fit (`fit_utility_regressor` less its samples), by wrapping
    the functions `build_utility_regressor` calls through its module."""

    NAMES = ("pretrain_trajectory", "phase1_samples", "fit_utility_regressor")

    def __enter__(self):
        import torch
        from repro_torch.fl import fedspace_setup as FS
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self._inner = {n: getattr(FS, n) for n in self.NAMES}

        def timed(name, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                return out
            return run
        for name, fn in self._inner.items():
            setattr(FS, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.fl import fedspace_setup as FS
        for name, fn in self._inner.items():
            setattr(FS, name, fn)

    def parts(self):
        s = self.seconds
        return {"pretrain": s["pretrain_trajectory"],
                "samples": s["phase1_samples"],
                "fit": s["fit_utility_regressor"] - s["phase1_samples"]}


def _drift(got, want, start) -> float:
    """|got - want| / |want - start| over the flattened leaves."""
    import numpy as np
    flat = [np.concatenate([np.ravel(x) for x in t])
            for t in (got, want, start)]
    return float(np.linalg.norm(flat[0] - flat[1])
                 / np.linalg.norm(flat[1] - flat[2]))


def run_densenet_path(torch):
    """Phase 7, the DenseNet path (Part A of
    examples/satellite_fl_train.py). (a) Part A's world under FedBuff
    (M 8) on the card, launch counts read around it, again from the
    initial model nudged by one rounding, then on the CPU from the same
    initial model: counters and staleness histogram equal, the frozen
    leaves bit for bit the initial model on both devices, the card's
    final model and accuracies as near the CPU's as `CHAOS_FACTOR` times
    the nudge moves them on the card; (b) Part A as a user runs
    it, FedSpace with phase 1 on the card (its seconds by part, R^2), the
    run (wall, counters, launches), then on the CPU with the same forest
    carried across: counters and every re-plan's schedule equal, or parted
    only on a forest split on T (ROADMAP C13); (c) one client update at M
    8 and M 20, card against CPU and twice on the card, then traced.
    Returns the launch counts of (a)'s and (b)'s card runs."""
    import math
    import numpy as np
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import forest_from_arrays, params_to_numpy
    counts = {}

    # (a)
    exp = densenet_experiment(SchedulerConfig(kind="fedbuff",
                                              params={"M": DENSENET_M}))
    fed = Federation.from_experiment(exp)
    p0 = params_to_numpy(fed.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    launch_counts.clear()
    t0 = time.perf_counter()
    eng = fed.engine(init_params=p0)
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["densenet fedbuff"] = dict(launch_counts)
    print("densenet fedbuff (cuda):", json.dumps(res.summary()), flush=True)
    print(f"densenet fedbuff (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, launches {counts['densenet fedbuff']}",
          flush=True)
    _one_launch_per_aggregation(res, counts["densenet fedbuff"])
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    r = np.random.default_rng(0)
    nudged = tree_map(lambda a: (a * (1 + 1e-7 * r.standard_normal(
        a.shape))).astype(a.dtype), p0)
    t0 = time.perf_counter()
    nudged_eng = fed.engine(init_params=nudged)
    nudged_res = nudged_eng.run()
    torch.cuda.synchronize()
    print(f"densenet fedbuff (cuda, nudged): wall "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    cpu_fed = Federation.from_experiment(exp, device="cpu")
    cpu_eng = cpu_fed.engine(init_params=p0, device="cpu")
    cpu = cpu_eng.run()
    print("densenet fedbuff (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    _same_counters(res, nudged_res)
    start = tree_leaves(p0)
    card_final, cpu_final, nudged_final = (
        tree_leaves(params_to_numpy(e.params))
        for e in (eng, cpu_eng, nudged_eng))
    frozen = [i for i, m in enumerate(tree_leaves(
        fed.adapter.trainable_mask(p0))) if m == 0.0]
    if not frozen or not all(np.array_equal(f[i], start[i]) for i in frozen
                             for f in (card_final, cpu_final)):
        raise AssertionError("a frozen leaf moved")
    drift = _drift(card_final, cpu_final, start)
    spread = _drift(nudged_final, card_final, start)
    gap = max(abs(a - b) for a, b in zip(res.accuracy, cpu.accuracy))
    acc_spread = max(abs(a - b) for a, b in zip(res.accuracy,
                                                nudged_res.accuracy))
    print(f"densenet fedbuff: {len(frozen)} frozen leaves bit for bit the "
          f"initial model on both devices; |card - CPU| / |CPU - p0| = "
          f"{drift!r}, the card's own under a 1e-7 nudge {spread!r}; "
          f"accuracies card {res.accuracy}, CPU {cpu.accuracy}, nudged "
          f"card {nudged_res.accuracy}: largest gap {gap!r}, the card's "
          f"own {acc_spread!r} (factor {CHAOS_FACTOR})", flush=True)
    if drift > CHAOS_FACTOR * spread or \
            gap > CHAOS_FACTOR * acc_spread + 1 / 600 + 1e-6:
        raise AssertionError("the card's run drifts from the CPU's beyond "
                             "its own spread")

    # (b)
    exp = densenet_experiment(SchedulerConfig(
        kind="fedspace", params=DENSENET_FEDSPACE, setup=DENSENET_SETUP))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Phase1Parts() as phase1:
        fs = Federation.from_experiment(exp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = fs.scheduler_diag
    print(f"densenet phase 1 (cuda): the world built in {secs:.3f} s, "
          f"phase 1 by part {json.dumps(phase1.parts())}; regressor R^2="
          f"{d['r2_in_sample']!r} on {d['n']} (s, T) -> dF samples, y_mean "
          f"{d['y_mean']!r}, y_std {d['y_std']!r}", flush=True)
    launch_counts.clear()
    t0 = time.perf_counter()
    with Replans() as card:
        res = fs.run(init_params=p0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["densenet fedspace"] = dict(launch_counts)
    print("densenet fedspace (cuda):", json.dumps(res.summary()), flush=True)
    print(f"densenet fedspace (cuda): wall {wall:.3f} s, re-plans "
          f"{len(card.log)}, launches {counts['densenet fedspace']}",
          flush=True)
    _one_launch_per_aggregation(res, counts["densenet fedspace"])
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    reg = fs.scheduler.regressor
    fa = reg.arrays()
    carried = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                                 fa.value, fa.depth,
                                 n_features=reg.n_features_)
    cpu_exp = densenet_experiment(SchedulerConfig(
        kind="fedspace", params={**DENSENET_FEDSPACE, "regressor": carried}))
    t0 = time.perf_counter()
    with Replans() as cpu_log:
        cpu = Federation.from_experiment(cpu_exp, device="cpu").run(
            init_params=p0)
    print("densenet fedspace (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    both = list(zip(card.log, cpu_log.log))
    print(f"densenet fedspace: T at each re-plan, card and CPU: "
          f"{[(a['status'], b['status']) for a, b in both]}; "
          f"{int((fa.feature == T_FEATURE).sum())} forest splits on T",
          flush=True)
    # the runs' accuracies move apart as (a)'s do: printed, not held
    if _same_schedules(card.log, cpu_log.log, reg, t_split_ok=True) is None:
        _same_counters(res, cpu)
        print(f"densenet fedspace: {len(card.log)} re-plans, schedules and "
              f"counters equal, card against CPU", flush=True)

    # (c)
    for m in (DENSENET_M, MAIN_PATH_M):
        check_client_update(torch, fed.adapter, cpu_fed.adapter, exp.train,
                            m=m, tols=(DENSENET_STEP_TOL,
                                       DENSENET_UPDATE_TOL))
        step = trace_client_update(torch, fed.adapter, exp.train, m=m)
        print("densenet client step", json.dumps(step), flush=True)
    return counts


# The scenarios phase: link budgets and inter-satellite links, through the
# worlds of the repo's own examples. (a) examples/scheduler_comparison.py
# as written: starlink40, 4 days (384 windows), 6000/1200 samples at noise
# 2.2, non-IID, the MLP at hidden 48, E 16 at lr 1.0, eval every 24, the
# ISLConfig(100 Mbit/s, 600 MB, epoch 24), all 7 policies; (b) the binding
# cell of examples/isl_comparison.py: starlink40 over sparse1, 2 days (192
# windows), 4000/800 samples, the MLP at its default width (64), E 8 at lr
# 1.0, eval every 48, LinkConfig(20, 100, 600 MB, one satellite a station:
# need_up 4, need_dn 1), fedbuff M 12, intra_plane and isl_async, plus
# FedSpace on the same budget (the link-gated search) with (a)'s forest.
SCENARIO_POLICIES = (("sync", {}), ("async", {}), ("fedbuff", {"M": 20}),
                     ("periodic", {"period": 4}), ("intra_plane", {}),
                     ("isl_async", {}))
SCENARIO_FEDSPACE = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 800}
SCENARIO_SETUP = {"pretrain_rounds": 30, "clients_per_round": 16,
                  "utility_samples": 150, "local_steps": 16,
                  "client_lr": 1.0}
ISL_CELL_POLICIES = (("fedbuff", {"M": 12}), ("intra_plane", {}),
                     ("isl_async", {}))
# (a)'s chaos-held policies (an aggregation nearly every window, each run
# also held against a nudged card run) run the world's first simulated day,
# which keeps the whole script well inside its time limit.
SCENARIO_SHORT = {"async": 96, "isl_async": 96}
# Accuracy card against CPU, at every evaluation: within 0.01 (as the
# quickstart path); where a run is chaotic (one update an aggregation at lr
# 1.0 carries a rounding difference on and grows it: ROADMAP C16) and the
# gap is wider, within CHAOS_FACTOR times the gap a nudge of the initial
# model by one rounding makes on the card, plus one argmax flip.
SCENARIO_ACC_TOL = 0.01


def _first_windows(fed, windows):
    """`fed` with its runs cut to their first `windows` windows: the same
    world, a shorter horizon."""
    import copy
    import dataclasses
    out = copy.copy(fed)
    out.experiment = dataclasses.replace(fed.experiment, train=(
        dataclasses.replace(fed.experiment.train, max_windows=windows)))
    return out


def scheduler_comparison_experiment():
    """examples/scheduler_comparison.py's world, as written."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment, ISLConfig,
                                    PartitionConfig, SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="scheduler_comparison",
        constellation=ConstellationConfig(preset="starlink40", days=4.0),
        dataset=DatasetConfig(num_train=6000, num_val=1200, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="mlp", params={"hidden": 48}),
        scheduler=SchedulerConfig(kind="sync"),
        train=EngineConfig(local_steps=16, client_lr=1.0, eval_every=24,
                           max_windows=384),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24))


def isl_cell_experiment():
    """examples/isl_comparison.py's binding cell: starlink40 over sparse1
    under the finite budget."""
    from repro_torch.fl.api import (ConstellationConfig, DatasetConfig,
                                    FLExperiment, ISLConfig, LinkConfig,
                                    SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="isl_comparison",
        constellation=ConstellationConfig(preset="starlink40",
                                          ground="sparse1", days=2.0),
        dataset=DatasetConfig(num_train=4000, num_val=800, noise=2.2),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 12}),
        train=EngineConfig(local_steps=8, client_lr=1.0, eval_every=48,
                           max_windows=192),
        link=LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=600.0, gs_capacity=1),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24))


def _columns(eng):
    """The engine's protocol state as host lists, the link and ISL
    columns among them (None where the run has none)."""
    return {name: (None if getattr(eng, name) is None
                   else getattr(eng, name).tolist())
            for name in ("version", "pending", "buffered_base",
                         "transfer_progress", "relay_units")}


def _scenario_pair(torch, tag, card_fed, cpu_fed, p0, counts,
                   regressor=None):
    """One policy (`tag` leads its lines): the card's run (launch counts
    read around it, wall), then the CPU's from the same initial model;
    every counter, the staleness histogram and the final protocol columns
    equal (for
    FedSpace, every re-plan under the C13 rule, and the rest where the
    schedules agree), the accuracies within `SCENARIO_ACC_TOL` or the
    card's own chaos. Returns (card result, card wall, CPU wall)."""
    import math
    import numpy as np
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_map
    launch_counts.clear()
    t0 = time.perf_counter()
    with Replans() as card_log:
        eng = card_fed.engine(init_params=p0)
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mine = dict(launch_counts)
    for k, v in mine.items():
        counts[k] = counts.get(k, 0) + v
    print(f"{tag} (cuda):", json.dumps(res.summary()), flush=True)
    print(f"{tag} (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, re-plans {len(card_log.log)}, launches "
          f"{mine}", flush=True)
    _one_launch_per_aggregation(res, mine)
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    t0 = time.perf_counter()
    with Replans() as cpu_log:
        cpu_eng = cpu_fed.engine(init_params=p0, device=cpu_fed.device)
        cpu = cpu_eng.run()
    cpu_wall = time.perf_counter() - t0
    print(f"{tag} (cpu): {json.dumps(cpu.summary())} wall "
          f"{cpu_wall:.3f} s", flush=True)
    card_cols, cpu_cols = _columns(eng), _columns(cpu_eng)
    print(f"{tag}: final progress card "
          f"{card_cols['transfer_progress']} CPU "
          f"{cpu_cols['transfer_progress']}; relay card "
          f"{card_cols['relay_units']} CPU {cpu_cols['relay_units']}",
          flush=True)
    if regressor is not None:
        if _same_schedules(card_log.log, cpu_log.log, regressor,
                           t_split_ok=True) is not None:
            return res, wall, cpu_wall
        print(f"{tag}: {len(card_log.log)} re-plans, schedules "
              f"equal, card against CPU", flush=True)
    _same_counters(res, cpu)
    if card_cols != cpu_cols:
        raise AssertionError(f"{tag}: protocol columns differ")
    gap = max(abs(a - b) for a, b in zip(res.accuracy, cpu.accuracy))
    if gap <= SCENARIO_ACC_TOL:
        print(f"{tag}: counters, histogram and columns equal; "
              f"accuracies within {gap!r} (tolerance {SCENARIO_ACC_TOL})",
              flush=True)
        return res, wall, cpu_wall
    r = np.random.default_rng(0)
    nudged = tree_map(lambda a: (a * (1 + 1e-7 * r.standard_normal(
        a.shape))).astype(a.dtype), p0)
    nres = card_fed.engine(init_params=nudged).run()
    spread = max(abs(a - b) for a, b in zip(res.accuracy, nres.accuracy))
    print(f"{tag}: counters, histogram and columns equal; "
          f"accuracies card {res.accuracy} CPU {cpu.accuracy} nudged card "
          f"{nres.accuracy}: gap {gap!r}, the card's own {spread!r} "
          f"(factor {CHAOS_FACTOR})", flush=True)
    if gap > CHAOS_FACTOR * spread + \
            1 / card_fed.experiment.dataset.num_val + 1e-6:
        raise AssertionError(f"{tag}: accuracy gap beyond the "
                             f"card's own spread")
    return res, wall, cpu_wall


def time_gated_replans(torch, fed, regressor, status, iters=20):
    """One re-plan's `score_candidates` at (b)'s shape (R 800, I0 24, K 40)
    on the card, CUDA events over `iters` calls after a warm-up, with the
    budget's gate over its served connectivity and without one over the
    geometric, from one random mid-run state."""
    import numpy as np
    from repro_torch.core import search as SR
    from repro_torch.core import staleness as SS
    b = fed.link_budget
    I0, R = SCENARIO_FEDSPACE["I0"], SCENARIO_FEDSPACE["num_candidates"]
    K = b.served.shape[1]
    r = np.random.default_rng(0)
    ig = 20
    cols = [torch.as_tensor(r.integers(-1, ig + 1, K).astype(np.int32),
                            device=fed.device) for _ in range(3)]
    progress = torch.as_tensor(r.integers(0, b.need_up, K).astype(np.int32),
                               device=fed.device)
    cands = SR.random_candidates(r, I0, 4, 8, R)
    gate = SS.LinkGate(b.grants[:I0], b.need_up, b.need_dn)
    row = {"R": R, "I0": I0, "K": K}
    for name, C, state, link in (
            ("gated", b.served[:I0], SS.SatState(*cols, progress=progress),
             gate),
            ("geometry", b.visible[:I0], SS.SatState(*cols), None)):
        def replan():
            return SR.score_candidates(cands, C, state, ig, regressor,
                                       status, link=link)
        if not np.isfinite(replan()).all():
            raise AssertionError(f"{name} re-plan scores not finite")
        row[f"{name}_ms"] = _time_ms(replan, iters)
    print("scenarios replan", json.dumps(row), flush=True)


def run_scenarios_path(torch):
    """Phase 8, the scenarios (`scenarios` lines): (a) every policy of
    examples/scheduler_comparison.py on its world, card against CPU
    (`_scenario_pair`), FedSpace with phase 1 on the card (its seconds)
    and the CPU with the forest carried across; (b) the binding cell of
    examples/isl_comparison.py (its blocked share), the three policies and
    FedSpace under the budget, card against CPU, the final `progress` and
    `relay` columns printed; (c) a re-plan's time with and without the
    gate. Returns the launch counts summed over the card's runs."""
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.weights import forest_from_arrays, params_to_numpy
    counts, walls = {}, {}
    t_phase = time.perf_counter()

    # (a)
    exp = scheduler_comparison_experiment()
    base = Federation.from_experiment(exp)
    cpu_base = Federation.from_experiment(exp, device="cpu")
    p0 = params_to_numpy(base.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    for name, kw in SCENARIO_POLICIES:
        card_w, cpu_w = base, cpu_base
        if name in SCENARIO_SHORT:
            card_w, cpu_w = (_first_windows(w, SCENARIO_SHORT[name])
                             for w in (base, cpu_base))
        _, card, cpu = _scenario_pair(
            torch, f"scenarios (a) {name}", card_w.with_scheduler(name, **kw),
            cpu_w.with_scheduler(name, **kw), p0, counts)
        walls[f"(a) {name}"] = (card, cpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Phase1Parts() as phase1:
        fs = base.with_scheduler(SchedulerConfig(
            "fedspace", params=SCENARIO_FEDSPACE, setup=SCENARIO_SETUP))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = fs.scheduler_diag
    print(f"scenarios (a) phase 1 (cuda): {secs:.3f} s, by part "
          f"{json.dumps(phase1.parts())}; regressor R^2="
          f"{d['r2_in_sample']!r} on {d['n']} samples", flush=True)
    reg = fs.scheduler.regressor
    fa = reg.arrays()
    carried = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                                 fa.value, fa.depth,
                                 n_features=reg.n_features_)
    fs_params = {**SCENARIO_FEDSPACE, "regressor": carried}
    res, card, cpu = _scenario_pair(
        torch, "scenarios (a) fedspace", fs,
        cpu_base.with_scheduler(SchedulerConfig("fedspace",
                                                params=fs_params)),
        p0, counts, regressor=reg)
    walls["(a) fedspace"] = (card, cpu)
    status = res.val_loss[0] if res.val_loss else 4.0

    # (b)
    exp = isl_cell_experiment()
    cell = Federation.from_experiment(exp)
    cpu_cell = Federation.from_experiment(exp, device="cpu")
    b = cell.link_budget
    print(f"scenarios (b): starlink40 over sparse1, need_up {b.need_up}, "
          f"need_dn {b.need_dn}, blocked_fraction {b.blocked_fraction()!r}"
          f" (CPU {cpu_cell.link_budget.blocked_fraction()!r}), relay "
          f"windows {cell.isl.relay_windows}", flush=True)
    p0 = params_to_numpy(cell.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    for name, kw in ISL_CELL_POLICIES:
        _, card, cpu = _scenario_pair(
            torch, f"scenarios (b) {name}", cell.with_scheduler(name, **kw),
            cpu_cell.with_scheduler(name, **kw), p0, counts)
        walls[f"(b) {name}"] = (card, cpu)
    fs_card = {**SCENARIO_FEDSPACE, "regressor": reg}
    _, card, cpu = _scenario_pair(
        torch, "scenarios (b) fedspace",
        cell.with_scheduler(SchedulerConfig("fedspace", params=fs_card)),
        cpu_cell.with_scheduler(SchedulerConfig("fedspace",
                                                params=fs_params)),
        p0, counts, regressor=reg)
    walls["(b) fedspace"] = (card, cpu)

    # (c)
    time_gated_replans(torch, cell, reg, status)
    print("scenarios walls (card s, CPU s)", json.dumps(walls), flush=True)
    print(f"scenarios: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"scenarios": counts}


# examples/fault_study.py's world, as written: starlink40 over dense12, 2
# days (192 windows), 4000/800 samples at noise 2.2, the MLP at its default
# width (64), E 8 at lr 1.0, eval every 48, LinkConfig(20, 100, 600 MB, two
# satellites a station), ISLConfig(100 Mbit/s, 600 MB, epoch 24); its five
# fault worlds; sync, fedbuff M 10 and intra_plane M 10 through the sweep,
# and FedSpace (I0 24, 4-8 aggregations, 512 candidates; phase 1 of 10
# rounds of 12 clients and 60 samples at E 8, lr 1.0) run one by one.
FAULT_K, FAULT_G, FAULT_WINDOWS = 40, 12, 192
FAULT_SWEEPABLE = (("sync", {}), ("fedbuff", {"M": FAULT_M}),
                   ("intra_plane", {"M": FAULT_M}))
FAULT_FEDSPACE = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 512}
FAULT_SETUP = {"pretrain_rounds": 10, "clients_per_round": 12,
               "utility_samples": 60, "local_steps": 8, "client_lr": 1.0}
# one sequential `.run()` a policy and a fault kind, held to the sweep
FAULT_SEQUENTIAL = (("churn40", "fedbuff"), ("blackout", "intra_plane"),
                    ("weather", "sync"))


def fault_scenarios():
    """examples/fault_study.py's five fault worlds, in its order."""
    from repro_torch.core.faults import random_churn, station_blackout
    from repro_torch.fl.api import FaultConfig
    K, G, W = FAULT_K, FAULT_G, FAULT_WINDOWS
    return (("clean", FaultConfig()),
            ("churn20", FaultConfig(deorbit=random_churn(K, W, 0.20,
                                                         seed=0))),
            ("churn40", FaultConfig(deorbit=random_churn(K, W, 0.40,
                                                         seed=0))),
            ("blackout", FaultConfig(outages=station_blackout(G, 64, 128))),
            ("weather", FaultConfig(rate_scale_min=0.25, rate_scale_max=1.0,
                                    seed=1)))


def fault_study_experiment():
    """examples/fault_study.py's base world, as written."""
    from repro_torch.fl.api import (ConstellationConfig, DatasetConfig,
                                    FLExperiment, ISLConfig, LinkConfig,
                                    SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="fault_study",
        constellation=ConstellationConfig(preset="starlink40",
                                          ground="dense12", days=2.0),
        dataset=DatasetConfig(num_train=4000, num_val=800, noise=2.2),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": FAULT_M}),
        train=EngineConfig(local_steps=8, client_lr=1.0, eval_every=48,
                           max_windows=FAULT_WINDOWS),
        link=LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=600.0, gs_capacity=2),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24))


class SweepLoops:
    """While the block runs: the number of window loops (groups) the
    sweep runs, each loop on the card under
    `torch.cuda.set_sync_debug_mode("error")`, so that a host read inside
    it fails."""

    def __enter__(self):
        import torch
        from repro_torch.fl import sweep
        self.groups, self._loop = 0, sweep._window_loop

        def loop(cols, **kw):
            self.groups += 1
            on_card = cols["C"].is_cuda
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                if self.groups == 1:      # the guard is live: a read fails
                    try:
                        cols["C"][0, 0, 0].item()
                    except RuntimeError:
                        pass
                    else:
                        raise AssertionError("sync debug mode let .item() "
                                             "through")
            try:
                return self._loop(cols, **kw)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        sweep._window_loop = loop
        return self

    def __exit__(self, *exc):
        from repro_torch.fl import sweep
        sweep._window_loop = self._loop


class Phase1Count:
    """Counts the FedSpace phase-1 builds `Federation` runs while the block
    runs (`build_utility_regressor`, called through `fl/api.py`)."""

    def __enter__(self):
        from repro_torch.fl import api
        self.calls, self._inner = 0, api.build_utility_regressor

        def counted(*args, **kw):
            self.calls += 1
            return self._inner(*args, **kw)
        api.build_utility_regressor = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.fl import api
        api.build_utility_regressor = self._inner


def _fault_row(res):
    """examples/fault_study.py's row numbers: idle %, updates, gradients,
    mean staleness."""
    hist = res.staleness_hist
    stale = sum(s * int(n) for s, n in enumerate(hist)) / max(
        int(hist.sum()), 1)
    return {"idle_pct": 100.0 * res.idle_connections
            / max(res.total_connections, 1),
            "updates": res.num_global_updates,
            "grads": res.num_aggregated_gradients, "stale": stale}


def _same_outcomes(card, cpu, tag):
    """Two sweep outcomes (or a run and an outcome) equal in every
    counter, the histogram and the final columns."""
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run"):
        a, b = getattr(card.result, name), getattr(cpu.result, name)
        if a != b:
            raise AssertionError(f"{tag}: {name} {a} against {b}")
    if card.result.staleness_hist.tolist() != \
            cpu.result.staleness_hist.tolist():
        raise AssertionError(f"{tag}: staleness histograms differ")
    for name in ("version", "pending", "buffered"):
        if getattr(card, name).tolist() != getattr(cpu, name).tolist():
            raise AssertionError(f"{tag}: final {name} differs")


def run_faults_path(torch):
    """Phase 9, the fault study (`faults` lines), examples/fault_study.py's
    world on the card against the CPU: (a) the 15 sweepable cells through
    `sweep_engines` on both (groups, walls; every outcome equal; the card's
    window loops under the sync guard; no kernel launched), and three
    cells run one by one through the card's `.run()`, held to the sweep;
    (b) FedSpace under each fault world (blind) and under churn40 as an
    oracle, phase 1 once on the card and the forest carried to the CPU
    (`_scenario_pair`: counters, columns, schedules under C13, one
    aggregation launch per aggregation); (c) the traces' numbers. Returns
    the launch counts summed over the card's runs."""
    import dataclasses
    from types import SimpleNamespace
    import numpy as np
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.fl.sweep import sweep_engines
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.agg.ops import FlatLayout
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import forest_from_arrays, params_to_numpy
    t_phase = time.perf_counter()
    exp = fault_study_experiment()
    scen = fault_scenarios()
    clean = Federation.from_experiment(exp)
    cpu_clean = Federation.from_experiment(exp, device="cpu")
    worlds = {n: clean.with_faults(c) for n, c in scen}
    cpu_worlds = {n: cpu_clean.with_faults(c) for n, c in scen}

    # (c) the traces: alive satellites at the end, contacts and grant
    # units the faults remove from the served world
    W = FAULT_WINDOWS
    for name, _ in scen:
        eng, cpu_eng = worlds[name].engine(), cpu_worlds[name].engine(
            device="cpu")
        if not (np.array_equal(eng.C, cpu_eng.C)
                and np.array_equal(eng._grants, cpu_eng._grants)):
            raise AssertionError(f"faults (c) {name}: the executed worlds "
                                 f"differ, card against CPU")
        tr = worlds[name].faults
        row = {"alive_at_end": FAULT_K if tr is None
               else int(tr.alive[W - 1].sum()),
               "contacts_removed": 1 - eng.C[:W].sum()
               / eng._plan_C[:W].sum(),
               "grant_loss": 1 - eng._grants[:W].sum()
               / eng._plan_grants[:W].sum()}
        print(f"faults (c) {name}:", json.dumps(
            {k: float(v) for k, v in row.items()}), flush=True)

    # (a) the sweep, card then CPU
    cells = [(n, kind, kw) for n, _ in scen for kind, kw in FAULT_SWEEPABLE]
    swept = {}
    for side, ws in (("cuda", worlds), ("cpu", cpu_worlds)):
        launch_counts.clear()
        with SweepLoops() as loops:
            t0 = time.perf_counter()
            # `run_sweep` is this call over the worlds' engines; its
            # outcomes keep the final columns compared below
            swept[side] = sweep_engines([
                w.engine(device=w.device) for w in
                (ws[n].with_scheduler(kind, **kw) for n, kind, kw in cells)])
            if side == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if side == "cuda" and sum(launch_counts.values()):
            raise AssertionError(f"the sweep launched kernels: "
                                 f"{dict(launch_counts)}")
        print(f"faults (a) sweep ({side}): {len(cells)} cells in "
              f"{loops.groups} groups, wall {wall:.3f} s"
              + (", window loops under sync debug mode 'error'"
                 if side == "cuda" else ""), flush=True)
    for (n, kind, _), card, cpu in zip(cells, swept["cuda"], swept["cpu"]):
        _same_outcomes(card, cpu, f"faults (a) {n} {kind}")
        print(f"faults (a) {n} {kind}:", json.dumps(_fault_row(card.result)),
              flush=True)
    print(f"faults (a): {len(cells)} outcomes equal, card against CPU",
          flush=True)
    counts = {}
    init = clean.adapter.init(torch.Generator().manual_seed(exp.seed))
    n = FlatLayout.of(tree_leaves(init)).size
    if n != FAULT_N:
        raise AssertionError(f"the fault study's flat model holds {n}, "
                             f"check_aggregation's FAULT_N {FAULT_N}")
    p0 = params_to_numpy(init)
    for name, kind in FAULT_SEQUENTIAL:
        kw = dict(FAULT_SWEEPABLE)[kind]
        launch_counts.clear()
        t0 = time.perf_counter()
        eng = worlds[name].with_scheduler(kind, **kw).engine(init_params=p0)
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mine = dict(launch_counts)
        for k, v in mine.items():
            counts[k] = counts.get(k, 0) + v
        _one_launch_per_aggregation(res, mine)
        (out,) = [o for (n, k, _), o in zip(cells, swept["cuda"])
                  if (n, k) == (name, kind)]
        _same_outcomes(SimpleNamespace(result=res, version=eng.version,
                                       pending=eng.pending,
                                       buffered=eng.buffered_base), out,
                       f"faults (a) {name} {kind} run")
        print(f"faults (a) {name} {kind} (cuda) run: wall {wall:.3f} s, "
              f"{res.num_global_updates} aggregations, launches {mine}; "
              f"equal to the sweep", flush=True)

    # (b) FedSpace under the faults: phase 1 once, on the card
    walls = {}
    fs_cfg = SchedulerConfig("fedspace", params=FAULT_FEDSPACE,
                             setup=FAULT_SETUP)
    with Phase1Count() as phase1:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg = clean.with_scheduler(fs_cfg).scheduler.regressor
        torch.cuda.synchronize()
        print(f"faults (b) phase 1 (cuda): {time.perf_counter() - t0:.3f} s",
              flush=True)
        fa = reg.arrays()
        carried = forest_from_arrays(fa.feature, fa.thresh, fa.left,
                                     fa.right, fa.value, fa.depth,
                                     n_features=reg.n_features_)
        cpu_cfg = SchedulerConfig("fedspace", params={
            **FAULT_FEDSPACE, "regressor": carried})
        runs = [(n, c) for n, c in scen] + [
            ("churn40 oracle", dataclasses.replace(dict(scen)["churn40"],
                                                   oracle=True))]
        for label, cfg in runs:
            _, card, cpu = _scenario_pair(
                torch, f"faults (b) {label}",
                clean.with_faults(cfg).with_scheduler(fs_cfg),
                cpu_clean.with_faults(cfg).with_scheduler(cpu_cfg), p0,
                counts, regressor=reg)
            walls[label] = (card, cpu)
    if phase1.calls != 1:
        raise AssertionError(f"phase 1 ran {phase1.calls} times")
    print("faults (b) walls (card s, CPU s)", json.dumps(walls), flush=True)
    print(f"faults: phase 1 ran once; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"faults": counts}


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
    paths["fedspace"] = run_fedspace_path(torch)
    done("fedspace path")
    paths.update(run_densenet_path(torch))
    done("densenet path")
    paths.update(run_scenarios_path(torch))
    done("scenarios path")
    paths.update(run_faults_path(torch))
    done("faults path")

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
    (r,) = [r for r in agg_rows if r["n"] == DENSENET_N
            and r["m"] == DENSENET_M and r["updates"] == "float32"]
    kernels[0]["densenet"] = {
        "work": "one DenseNet aggregation: one launch over N = 12,512 at "
                "M = 8, float32",
        **{k: r[k] for k in ("design", "max_abs_err", "bound_ms", "bound_by",
                             "plain_ms", "library_ms")}, "ms": r["kernel_ms"]}
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
