"""Hooks for `repro_torch.fl.engine.SimulationEngine`.

A callback observes the run at well-defined events and may request an
early stop; it never mutates protocol state. Events (all optional):

    on_run_begin(engine)
    on_window_end(engine, window)
    on_aggregate_end(engine, window, info)     # info: ig, n_aggregated, ...
    on_eval(engine, window, metrics)           # metrics: accuracy, ...
    on_run_end(engine, result)
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from repro_torch.ckpt.checkpoint import save_pytree


class Callback:
    """No-op base; subclass and override the events you care about."""

    def on_run_begin(self, engine):
        pass

    def on_window_end(self, engine, window: int):
        pass

    def on_aggregate_end(self, engine, window: int, info: dict):
        pass

    def on_eval(self, engine, window: int, metrics: dict):
        pass

    def on_run_end(self, engine, result):
        pass


class JsonlMetricsCallback(Callback):
    """Stream eval metrics (and the final summary) to a JSONL file — one
    JSON object per line, flushed as it happens, so a long simulation can
    be tailed/plotted live."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def on_run_begin(self, engine):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # one file = one run: truncate so a re-run with the same path
        # doesn't interleave events from a previous (possibly crashed) run
        self._f = open(self.path, "w")
        self._write({"event": "run_begin", "scheme": engine.scheduler.name,
                     "num_windows": engine.num_windows, "K": engine.K})

    def on_eval(self, engine, window, metrics):
        self._write({"event": "eval", **metrics})

    def on_run_end(self, engine, result):
        if self._f is None:
            return
        self._write({"event": "run_end", **result.summary()})
        self._f.close()
        self._f = None

    def _write(self, obj: dict):
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()


class CheckpointCallback(Callback):
    """Persist the global model every `every` global updates (and at run
    end) as npz trees under `directory` (`save_pytree`: the reference's
    file names and keys)."""

    def __init__(self, directory: str, every: int = 10):
        self.directory = directory
        self.every = max(1, every)

    def on_aggregate_end(self, engine, window, info):
        if info["ig"] % self.every == 0:
            self._save(engine, info["ig"])

    def on_run_end(self, engine, result):
        self._save(engine, engine.ig)

    def _save(self, engine, ig: int):
        save_pytree(os.path.join(self.directory, f"model_v{ig:06d}.npz"),
                    engine.params)


class EarlyStopCallback(Callback):
    """Stop when validation accuracy has not improved by `min_delta` for
    `patience` consecutive evals."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.stale_evals = 0

    def on_run_begin(self, engine):
        self.best, self.stale_evals = None, 0

    def on_eval(self, engine, window, metrics):
        acc = metrics["accuracy"]
        if self.best is None or acc > self.best + self.min_delta:
            self.best, self.stale_evals = acc, 0
        else:
            self.stale_evals += 1
            if self.stale_evals >= self.patience:
                engine.request_stop()


class ProgressCallback(Callback):
    """Human-readable one-liners per eval (quickstart/launcher UX)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._t0 = None

    def on_run_begin(self, engine):
        self._t0 = time.time()

    def on_eval(self, engine, window, metrics):
        print(f"{self.prefix}[{engine.scheduler.name}] day "
              f"{metrics['day']:5.2f}  acc={metrics['accuracy']:.3f}  "
              f"val_loss={metrics['val_loss']:.3f}  "
              f"updates={metrics['global_updates']}  "
              f"({time.time() - self._t0:.0f}s)", flush=True)
