"""Hooks for `repro_torch.fl.engine.SimulationEngine`.

A callback observes the run at well-defined events and may request an
early stop; it never mutates protocol state. Events (all optional):

    on_run_begin(engine)
    on_window_end(engine, window)
    on_aggregate_end(engine, window, info)     # info: ig, n_aggregated, ...
    on_eval(engine, window, metrics)           # metrics: accuracy, ...
    on_run_end(engine, result)

The reference's checkpoint, early-stop and progress callbacks are not
ported yet.
"""
from __future__ import annotations

import json
import os


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
