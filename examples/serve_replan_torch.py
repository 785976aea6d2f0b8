"""examples/serve_replan.py on the PyTorch port: replanning as a service.
Fit the utility forest û once on flock191 (the "calibration"
constellation), then serve eq.-13 schedule re-plans for *other*
constellations from long-lived `ReplanService` instances on the card — no
refit per constellation.

Two pieces of the framework meet here:

* **Forest transfer** (`repro_torch.core.utility.transfer_ready`): the
  search featurization depends only on `s_max`, never on the satellite
  count, so the flock191-fitted forest answers starlink40/120/400
  requests unchanged; `transfer_report` shows how far each serving
  constellation sits outside the calibration envelope.
* **Delta-window scoring** (`repro_torch.fl.replan.ReplanService`):
  consecutive aggregation events reuse the cached rollouts over the
  overlapping horizon and roll only the newly revealed window, with
  `maintain()` run between requests so frontier upkeep stays off the
  answer path. The protocol state, the rollouts and the scores live on
  the card; the candidate pools are drawn on the host.

Run:  PYTHONPATH=src python examples/serve_replan_torch.py
"""
import time

import numpy as np
import torch

from repro_torch.core import connectivity as CN
from repro_torch.core import staleness as SS
from repro_torch.core.utility import (RandomForestRegressor, featurize,
                                      transfer_report)
from repro_torch.device import resolve_device
from repro_torch.fl.replan import ReplanService

S_MAX = 8
DAYS = 0.25                    # 24 fifteen-minute windows per preset


def _preset_hists(preset: str, device, s_max: int = S_MAX) -> np.ndarray:
    """Per-window staleness histograms from protocol rollouts of `preset`
    under a few periodic cadences (a spread of staleness mixes)."""
    C = CN.connectivity_sets(CN.constellation_preset(preset), days=DAYS)
    state = SS.bootstrap_state(C.shape[1], device=device)
    hists = []
    for period in (2, 3, 4, 6):
        a = (np.arange(C.shape[0]) % period == period - 1).astype(np.int32)
        _, _, infos = SS.simulate_window(C, a, state, 0, s_max=s_max,
                                         collect="hist")
        hists.append(infos["hist"].cpu().numpy())
    return np.concatenate(hists).astype(np.float32)


def calibrate(device, s_max: int = S_MAX) -> RandomForestRegressor:
    """Fit û on flock191 rollouts against the staleness-discounted
    aggregate-mass curve (the synthetic stand-in for eq.-12 targets)."""
    H = _preset_hists("flock191", device, s_max)
    X = featurize(H, 1.0)
    s = np.arange(s_max + 1, dtype=np.float32)
    y = ((H * (1.2 - 0.3 * s)).sum(1)
         / np.maximum(H.sum(1), 1.0)).astype(np.float32)
    return RandomForestRegressor(n_trees=30, max_depth=6, seed=0).fit(X, y)


def serve(preset: str, rf: RandomForestRegressor, device, *, I0: int = 12,
          steps: int = 6, num_candidates: int = 2000):
    """One serving session: stream `steps` consecutive aggregation events
    for `preset` through a persistent service, realizing each returned
    schedule's first action against the true protocol state."""
    C = CN.connectivity_sets(CN.constellation_preset(preset), days=DAYS)
    K = C.shape[1]
    rep = transfer_report(rf, featurize(_preset_hists(preset, device), 1.0))
    print(f"{preset} (K={K}): in_envelope="
          f"{rep.get('in_envelope', 1.0):.2f}, "
          f"pred range [{rep['pred_min']:.3f}, {rep['pred_max']:.3f}]")

    svc = ReplanService(rf, I0=I0, num_candidates=num_candidates,
                        s_max=S_MAX, seed=0, min_pool=64)
    state = SS.bootstrap_state(K, device=device)
    ig = 0
    rng = np.random.default_rng(1)
    for i in range(steps):
        Cw = C[i:i + I0]
        t0 = time.perf_counter()
        plan = svc.replan(i, Cw, state, ig, 1.0, rng=rng)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"  window {i:2d}: {svc.last_mode:5s} "
              f"{'(' + svc.last_reason + ')' if svc.last_reason else '':14s}"
              f"{dt:8.1f} ms  schedule={''.join(map(str, plan))}")
        svc.maintain()             # frontier upkeep between requests
        state, g, _ = SS.step(state, ig,
                              torch.as_tensor(C[i], device=device),
                              bool(plan[0]), s_max=S_MAX, collect="none")
        ig = int(g)
    print(f"  stats: {svc.stats}")


def main(device=None):
    device = resolve_device(device)
    rf = calibrate(device)
    print(f"calibrated on flock191: {rf.n_trees} trees, "
          f"{rf.n_features_} features\n")
    for preset in ["starlink40", "starlink120", "starlink400"]:
        serve(preset, rf, device)
        print()


if __name__ == "__main__":
    main()
