#!/usr/bin/env python3
"""Where the time of the quickstart FedBuff run goes on one NVIDIA GPU.

    python3 scripts/trace_quickstart.py

Runs the port's quickstart FedBuff federation (the experiment of
`chip_smoke.py`) three times on the card after a warm-up run:
  1. untimed, for the run's wall time;
  2. with every protocol step of the engine timed on the host clock,
     each step fenced by `torch.cuda.synchronize()` so its device work is
     charged to it (the fences are the instrumentation's cost: run 2's
     wall minus run 1's);
  3. under `torch.profiler`, for the device's busy time and the kernels
     by name.
Prints one JSON object per line and writes them all to
`chiprun_out/trace_quickstart.json`.
"""
from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import quickstart_experiment  # noqa: E402
from repro_torch.fl.api import Federation  # noqa: E402
from repro_torch.fl.engine import SimulationEngine  # noqa: E402

STEPS = ("on_uploads", "on_decide", "on_aggregate", "_train_buffered",
         "on_downloads", "evaluate")


class TimedEngine(SimulationEngine):
    """The engine with each protocol step fenced and timed."""

    def prepare(self):
        super().prepare()
        self.seconds, self.calls = Counter(), Counter()

    def _timed(self, name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds[name] += time.perf_counter() - t0
        self.calls[name] += 1
        return out

    def on_uploads(self, i, conn):
        return self._timed("on_uploads", super().on_uploads, i, conn)

    def on_decide(self, i, n_buf):
        return self._timed("on_decide", super().on_decide, i, n_buf)

    def on_aggregate(self, i):
        return self._timed("on_aggregate", super().on_aggregate, i)

    def _train_buffered(self, ks, buffered, *, round_rng):
        return self._timed("_train_buffered", super()._train_buffered, ks,
                           buffered, round_rng=round_rng)

    def on_downloads(self, i, conn):
        return self._timed("on_downloads", super().on_downloads, i, conn)

    def evaluate(self, i):
        return self._timed("evaluate", super().evaluate, i)


def _engine(fed, cls):
    plain = fed.engine()
    return cls(plain.C, fed.adapter, fed.scheduler, plain.config,
               device=fed.device)


def _wall(engine):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_quickstart: no CUDA device", file=sys.stderr)
        return 1
    out = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        out.append(obj)

    emit({"device": torch.cuda.get_device_name(0)})
    fed = Federation.from_experiment(quickstart_experiment())
    _wall(fed.engine())                                   # warm-up
    wall, res = _wall(fed.engine())
    emit({"run": "untimed", "wall_s": wall, "windows": res.windows_run,
          "aggregations": res.num_global_updates})

    timed = _engine(fed, TimedEngine)
    twall, _ = _wall(timed)
    emit({"run": "steps timed", "wall_s": twall,
          "instrumentation_s": twall - wall,
          "steps": {k: {"s": timed.seconds[k], "calls": timed.calls[k]}
                    for k in STEPS}})

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pwall, _ = _wall(fed.engine())
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): host ops also report
        # the device time of the kernels they launched
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    agg = [(d, c) for d, k, c in rows if "agg_kernel" in k]
    emit({"run": "profiled", "wall_s": pwall, "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / pwall,
          "device_launches": sum(r[2] for r in rows),
          "agg_kernel": {"device_ms": sum(d for d, _ in agg) / 1e3,
                         "launches": sum(c for _, c in agg)},
          "top_kernels": [{"name": k[:80], "device_ms": d / 1e3, "count": c}
                          for d, k, c in rows[:15]]})
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "trace_quickstart.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
