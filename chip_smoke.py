#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit) when it fails:
  1. device: the card's name, count, and `nvidia-smi` name/power limit;
  2. build: every CUDA source of the port built with nvcc for sm_90a
     (one nvcc per source, all started together), with ptxas's report;
  3. kernels against their plain PyTorch versions at the main path's
     shapes and at the paper's model size, with CUDA-event timings
     (kernel, plain version, one-call library yardstick) beside the
     least time the card could take for the same work;
  4. the main path: the quickstart FedBuff federation through
     `Federation.from_experiment(exp).run()` on the card, launch counts
     read around it, then the same experiment on the CPU as the check;
  5. one JSON line listing every ported kernel.
The last line is `{"ok": true, "device": {...}}`. Without a CUDA device,
or away from the repository's sources, it exits nonzero and prints no
result. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM rate and float32 outside the
# tensor cores. The aggregation reads and writes float32/bfloat16 and does
# its multiply-adds on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
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


def _agg_bound(m: int, n: int, upd_bytes: int, par_bytes: int = 4):
    """Least time for one aggregation: every input read once, the output
    written once, against 2*M*N float32 operations."""
    moved = (m * upd_bytes + 2 * par_bytes) * n + 4 * m
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """Phase 4. Returns the launch counts of the card's run."""
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
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run",
                 "eval_windows"):
        if getattr(res, name) != getattr(cpu, name):
            raise AssertionError(f"{name}: card {getattr(res, name)} vs "
                                 f"CPU {getattr(cpu, name)}")
    if res.staleness_hist.tolist() != cpu.staleness_hist.tolist():
        raise AssertionError("staleness histograms differ")
    # accuracy counts argmax hits on 1000 validation samples; float32
    # products summed in another order on the card may flip a few of them
    acc_err = abs(res.accuracy[-1] - cpu.accuracy[-1])
    print(f"final accuracy: card {res.accuracy[-1]} CPU {cpu.accuracy[-1]}"
          f" (|diff| {acc_err}, tolerance 0.01)", flush=True)
    if acc_err > 0.01:
        raise AssertionError("final accuracy differs beyond tolerance")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.agg import kernel as agg_kernel

    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {name} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(smi.splitlines()[0], flush=True)      # name, power limit

    # 2. build
    for b in build.build([agg_kernel.SOURCE]):
        print(f"built {b.source.relative_to(ROOT)} -> "
              f"{b.library.relative_to(ROOT)} in {b.seconds:.1f} s",
              flush=True)
        print(b.log.strip(), flush=True)

    # 3. kernels against their plain versions
    rows = check_aggregation(torch)

    # 4. the main path
    counts = run_main_path(torch)

    # 5. the kernels line: the main path's work for one aggregation is the
    # four quickstart leaves at M=20 in float32
    work = [r for r in rows if r["n"] in QUICKSTART_LEAVES
            and r["m"] == MAIN_PATH_M and r["updates"] == "float32"]
    kernels = [{
        "name": agg_kernel.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/agg/csrc/agg.cu",
        "replaces": "src/repro/kernels/agg/kernel.py:35",
        "launches": counts.get(agg_kernel.NAME, 0),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["kernel_ms"] for r in work),
        "plain_ms": sum(r["plain_ms"] for r in work),
        "bound_ms": sum(r["bound_ms"] for r in work),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in work)
                    else "operations",
        "library_ms": sum(r["library_ms"] for r in work),
        "work": "one quickstart aggregation: leaves N=1536,48,2976,62 at "
                "M=20, float32",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
