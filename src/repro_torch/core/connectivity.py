"""Deterministic satellite-to-ground-station connectivity (paper §2.2).

Replaces the `cote` simulator (unavailable offline) with a first-principles
propagator: circular Keplerian orbits for a Planet-Flock-like constellation
(sun-synchronous, ~475 km, 97.4 deg inclination) + Earth rotation for the
ground stations + minimum-elevation-angle visibility. The output is the
sequence of connectivity sets C = {C_0, C_1, ...} with period T0 (eq. 2):
satellite k is in C_i if a link to ANY ground station is feasible at some
time inside window i.

Everything is deterministic given the constellation spec — the property
FedSpace exploits (§3.1).

Beyond the paper's single Planet-Flock scenario, this module carries the
constellation scenario suite: multi-shell Walker-style specs (`Shell`),
named ground-station networks (`GROUND_NETWORKS`), and registry-exposed
presets (`repro_torch.fl.registry.CONSTELLATIONS`) from the 191-satellite
Planet-Flock baseline up to a 1000-satellite Starlink-like family — the
regimes mega-constellation FL work (Matthiesen et al. 2022, Razmi et al.
2021) evaluates. Select a preset by name through
`repro_torch.fl.api.ConstellationConfig(preset=...)` or build one directly
with `constellation_preset`.

This is the port's own numpy copy of the JAX package's geometry layer
(`repro.core.connectivity`), so both packages derive bit-identical
connectivity from one spec. The per-station link-budget layer
(`LinkBudget`, `station_windows`, `resolve_contention`,
`transfer_windows`, `link_budget`) is not here yet: it comes with the
link-budget slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np

from repro_torch.fl.registry import CONSTELLATIONS, register_constellation

MU = 3.986004418e14           # m^3/s^2
R_EARTH = 6_371_000.0         # m
OMEGA_EARTH = 7.2921159e-5    # rad/s

# 12 Planet-like ground-station sites (lat, lon) — polar-heavy, as real
# downlink networks are.
DEFAULT_GROUND_STATIONS: List[Tuple[str, float, float]] = [
    ("svalbard", 78.23, 15.39),
    ("troll_antarctica", -72.01, 2.53),
    ("inuvik", 68.32, -133.55),
    ("fairbanks", 64.86, -147.85),
    ("kiruna", 67.89, 20.41),
    ("punta_arenas", -53.16, -70.91),
    ("awarua_nz", -46.53, 168.38),
    ("hartebeesthoek", -25.89, 27.69),
    ("dubai", 25.20, 55.27),
    ("bremen", 53.08, 8.80),
    ("ohio", 40.37, -83.06),
    ("seoul", 37.57, 126.98),
]


# Named ground networks for the scenario suite: the paper-like polar-heavy
# 12-site network, a mid-size commercial subset, and the degenerate
# single-station case (every model update funnels through Svalbard).
GROUND_NETWORKS: dict = {
    "dense12": tuple(DEFAULT_GROUND_STATIONS),
    "mid4": tuple(g for g in DEFAULT_GROUND_STATIONS
                  if g[0] in ("svalbard", "troll_antarctica", "inuvik",
                              "awarua_nz")),
    "sparse1": (("svalbard", 78.23, 15.39),),
}


@dataclass(frozen=True)
class Shell:
    """One Walker-style orbital shell of a multi-shell constellation."""
    num_satellites: int
    num_planes: int
    altitude_m: float
    inclination_deg: float
    raan_spread_deg: float = 360.0


@dataclass(frozen=True)
class ConstellationSpec:
    """Deterministic constellation + ground-network description.

    Two modes:
      * single-shell (default, ``shells=()``): the paper's Planet-Flock
        mix — `num_satellites` spread over `num_planes` sun-synchronous
        planes with an `iss_fraction` of them moved to the ISS orbit;
      * multi-shell (``shells`` non-empty): each `Shell` is an independent
        Walker-style layer (Starlink-like); `num_satellites` must equal
        the sum of shell sizes, and the ISS fields are ignored.

    Everything — including the phase jitter — is a pure function of the
    spec, so two processes given the same spec derive the same C (§3.1).
    """
    num_satellites: int = 191
    num_planes: int = 8
    altitude_m: float = 475_000.0
    inclination_deg: float = 97.4
    iss_fraction: float = 0.5          # Flock 2e/2e' satellites on ISS orbit
    iss_inclination_deg: float = 51.6
    iss_altitude_m: float = 420_000.0
    min_elevation_deg: float = 50.0
    raan_spread_deg: float = 360.0
    phase_jitter: float = 0.35     # fraction of slot spacing (deterministic)
    seed: int = 17
    ground_stations: Tuple[Tuple[str, float, float], ...] = tuple(
        DEFAULT_GROUND_STATIONS)
    shells: Tuple[Shell, ...] = ()


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    z = np.zeros_like(a)
    o = np.ones_like(a)
    return np.stack([np.stack([c, -s, z], -1),
                     np.stack([s, c, z], -1),
                     np.stack([z, z, o], -1)], -2)


def satellite_elements(spec: ConstellationSpec):
    """Per-satellite (raan, inclination, phase, altitude) — deterministic.

    Single-shell specs reproduce the paper-era Planet-Flock layout
    bit-for-bit; multi-shell specs concatenate one Walker-style layer per
    `Shell`, each drawing its phase jitter from the same seeded stream.
    """
    rng = np.random.default_rng(spec.seed)
    if spec.shells:
        total = sum(s.num_satellites for s in spec.shells)
        if total != spec.num_satellites:
            raise ValueError(
                f"num_satellites={spec.num_satellites} but shells sum to "
                f"{total}: {spec.shells}")
        parts = [_shell_elements(s, rng, spec.phase_jitter)
                 for s in spec.shells]
        return tuple(np.concatenate([p[j] for p in parts])
                     for j in range(4))
    K = spec.num_satellites
    planes = np.arange(K) % spec.num_planes
    raan = planes / spec.num_planes * np.deg2rad(spec.raan_spread_deg)
    per_plane = np.ceil(K / spec.num_planes)
    slot = np.arange(K) // spec.num_planes
    phase = (slot / per_plane * 2 * np.pi
             + planes * 0.5                      # inter-plane phasing
             + rng.uniform(-1, 1, K) * spec.phase_jitter
             * 2 * np.pi / per_plane)
    inc = np.full(K, np.deg2rad(spec.inclination_deg))
    n_iss = int(K * spec.iss_fraction)
    iss_idx = rng.permutation(K)[:n_iss]
    inc[iss_idx] = np.deg2rad(spec.iss_inclination_deg)
    alt = np.full(K, spec.altitude_m)
    alt[iss_idx] = spec.iss_altitude_m
    return raan, inc, phase, alt


def _shell_elements(shell: Shell, rng: np.random.Generator,
                    phase_jitter: float):
    """Walker-style elements for one shell (same slot/plane layout and
    jitter convention as the single-shell path)."""
    K = shell.num_satellites
    planes = np.arange(K) % shell.num_planes
    raan = planes / shell.num_planes * np.deg2rad(shell.raan_spread_deg)
    per_plane = np.ceil(K / shell.num_planes)
    slot = np.arange(K) // shell.num_planes
    phase = (slot / per_plane * 2 * np.pi
             + planes * 0.5
             + rng.uniform(-1, 1, K) * phase_jitter * 2 * np.pi / per_plane)
    inc = np.full(K, np.deg2rad(shell.inclination_deg))
    alt = np.full(K, shell.altitude_m)
    return raan, inc, phase, alt


def satellite_positions_eci(spec: ConstellationSpec, times: np.ndarray):
    """ECI positions (T, K, 3) at times (s)."""
    raan, inc, phase, alt = satellite_elements(spec)
    r = R_EARTH + alt                             # (K,)
    n = np.sqrt(MU / r ** 3)                      # mean motion rad/s (K,)
    theta = times[:, None] * n + phase[None, :]   # (T, K)
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    ci, si = np.cos(inc), np.sin(inc)
    cr, sr = np.cos(raan), np.sin(raan)
    # orbit plane: rotate (x, y, 0) by inclination about x, then RAAN about z
    xi = x
    yi = y * ci
    zi = y * si
    xe = cr * xi - sr * yi
    ye = sr * xi + cr * yi
    return np.stack([xe, ye, np.broadcast_to(zi, xe.shape)], -1)


def ground_positions_eci(spec: ConstellationSpec, times: np.ndarray):
    """ECI positions (T, G, 3) of ground stations under Earth rotation."""
    lats = np.deg2rad([g[1] for g in spec.ground_stations])
    lons = np.deg2rad([g[2] for g in spec.ground_stations])
    clat = np.cos(lats)
    ecef = R_EARTH * np.stack(
        [clat * np.cos(lons), clat * np.sin(lons), np.sin(lats)], -1)  # (G,3)
    ang = OMEGA_EARTH * times                                          # (T,)
    rot = _rot_z(ang)                                                  # (T,3,3)
    return np.einsum("tij,gj->tgi", rot, ecef)


def visibility(spec: ConstellationSpec, times: np.ndarray, *,
               time_chunk: int = 128) -> np.ndarray:
    """(T, K) bool: satellite visible from any GS above min elevation.

    Computed in time blocks of `time_chunk` steps so peak memory is
    O(time_chunk * K * G) instead of O(T * K * G) — at mega-constellation
    scale (K=1000, G=12, multi-day horizons) the one-shot broadcast is
    multiple GB while the blocked sweep stays a few tens of MB. Results
    are bit-identical to the unblocked computation (pure slicing).
    """
    time_chunk = max(int(time_chunk), 1)
    out = np.empty((len(times), spec.num_satellites), bool)
    for t0 in range(0, len(times), time_chunk):
        out[t0:t0 + time_chunk] = _visibility_block(
            spec, times[t0:t0 + time_chunk])
    return out


def _station_visibility_block(spec: ConstellationSpec, times: np.ndarray):
    """(T, K, G) bool: satellite k visible from station g at each time."""
    sat = satellite_positions_eci(spec, times)     # (T,K,3)
    gs = ground_positions_eci(spec, times)         # (T,G,3)
    d = sat[:, :, None, :] - gs[:, None, :, :]     # (T,K,G,3)
    up = gs / np.linalg.norm(gs, axis=-1, keepdims=True)
    dn = np.linalg.norm(d, axis=-1)
    sin_elev = np.einsum("tkgi,tgi->tkg", d, up) / np.maximum(dn, 1.0)
    return sin_elev >= np.sin(np.deg2rad(spec.min_elevation_deg))


def _visibility_block(spec: ConstellationSpec, times: np.ndarray):
    return _station_visibility_block(spec, times).any(axis=2)


def connectivity_sets(spec: ConstellationSpec, *, t0_s: float = 900.0,
                      days: float = 5.0, substep_s: float = 60.0
                      ) -> np.ndarray:
    """C as a boolean matrix (num_windows, K): k in C_i iff a link is
    feasible at any substep inside window i (paper uses T0 = 15 min)."""
    num_windows = int(round(days * 86400.0 / t0_s))
    per = int(round(t0_s / substep_s))
    times = np.arange(num_windows * per) * substep_s
    vis = visibility(spec, times)                  # (num_windows*per, K)
    return vis.reshape(num_windows, per, -1).any(axis=1)


def connectivity_stats(C: np.ndarray, windows_per_day: int = 96) -> dict:
    """Fig. 2 statistics: |C_i| over time and per-satellite contacts/day.

    Args:
      C: (num_windows, K) bool connectivity matrix.
      windows_per_day: calendar scaling for the contacts/day figures
        (96 = 15-minute windows).

    Returns a dict with scalar summaries (ci_min/ci_max/ci_mean over
    per-window set sizes, nk_min/nk_max/nk_mean over per-satellite
    contacts per day) plus the underlying `sizes` (num_windows,) and
    `contacts_per_day` (K,) arrays. Horizons shorter than one day are
    rate-scaled instead of producing NaN, so scenario smoke runs can
    sanity-check presets on a handful of windows.
    """
    C = np.asarray(C, bool)
    sizes = C.sum(axis=1)
    days = C.shape[0] // windows_per_day
    if days >= 1:
        nk = C[:days * windows_per_day].reshape(days, windows_per_day, -1)
        contacts_per_day = nk.sum(axis=1).mean(axis=0)   # (K,)
    else:   # sub-day horizon: scale the observed contact rate to a day
        contacts_per_day = C.sum(axis=0) * (windows_per_day / C.shape[0])
    return {
        "ci_min": int(sizes.min()), "ci_max": int(sizes.max()),
        "ci_mean": float(sizes.mean()),
        "nk_min": float(contacts_per_day.min()),
        "nk_max": float(contacts_per_day.max()),
        "nk_mean": float(contacts_per_day.mean()),
        "sizes": sizes, "contacts_per_day": contacts_per_day,
    }


# ---------------------------------------------------------------------------
# Scenario suite: registry-exposed constellation presets.
#
# Every preset is a factory `f(*, ground=None, **overrides) ->
# ConstellationSpec`: `ground` picks a GROUND_NETWORKS entry (None keeps
# the preset's default), remaining overrides are `dataclasses.replace`
# fields — so any scheduler runs on any preset, ground network, and knob
# combination through one declarative path.


def resolve_spec(base: ConstellationSpec, ground=None,
                 overrides=None) -> ConstellationSpec:
    """Apply a named ground network and field overrides to `base`.

    `ground` (a GROUND_NETWORKS key, None = keep base) is applied first,
    then `overrides` replace fields — so an explicit
    ``overrides["ground_stations"]`` wins over `ground`, identically for
    preset and ad-hoc construction paths. Unknown network names raise a
    KeyError listing what is known."""
    if ground is not None:
        try:
            stations = GROUND_NETWORKS[ground]
        except KeyError:
            known = ", ".join(sorted(GROUND_NETWORKS))
            raise KeyError(f"unknown ground network {ground!r}; known: "
                           f"{known}") from None
        base = replace(base, ground_stations=stations)
    return replace(base, **overrides) if overrides else base


@register_constellation("flock191")
def flock191(*, ground=None, **overrides):
    """The paper's scenario: 191 Planet-Flock satellites (§2.1), half on
    the ISS orbit, against the polar-heavy 12-station network."""
    return resolve_spec(ConstellationSpec(), ground, overrides)


# Starlink-like multi-shell family. Shell geometry loosely follows the
# phase-1 Starlink shells (53.0 / 53.2 deg mid-inclination + a polar
# layer); gateway terminals track to lower elevation than Planet's
# imaging downlinks, hence min_elevation 25 deg.
_STARLINK_FAMILY = {
    "starlink40": (Shell(24, 4, 550_000.0, 53.0),
                   Shell(16, 4, 560_000.0, 97.6)),
    "starlink120": (Shell(72, 6, 550_000.0, 53.0),
                    Shell(32, 4, 540_000.0, 53.2),
                    Shell(16, 4, 560_000.0, 97.6)),
    "starlink400": (Shell(240, 12, 550_000.0, 53.0),
                    Shell(96, 8, 540_000.0, 53.2),
                    Shell(64, 8, 560_000.0, 97.6)),
    "starlink1000": (Shell(600, 24, 550_000.0, 53.0),
                     Shell(240, 12, 540_000.0, 53.2),
                     Shell(160, 10, 560_000.0, 97.6)),
}


def _register_starlink(name: str, shells: Tuple[Shell, ...]):
    def factory(*, ground=None, **overrides):
        base = ConstellationSpec(
            num_satellites=sum(s.num_satellites for s in shells),
            shells=shells, min_elevation_deg=25.0)
        return resolve_spec(base, ground, overrides)
    factory.__name__ = name
    factory.__doc__ = (f"Starlink-like multi-shell constellation with "
                       f"{sum(s.num_satellites for s in shells)} "
                       f"satellites over {len(shells)} shells.")
    register_constellation(name, factory)
    return factory


for _name, _shells in _STARLINK_FAMILY.items():
    _register_starlink(_name, _shells)


def constellation_preset(name: str, *, ground: str = None,
                         **overrides) -> ConstellationSpec:
    """Build a registered constellation preset by name.

    Args:
      name: preset key (`repro_torch.fl.registry.CONSTELLATIONS`; unknown names
        raise a KeyError listing what is registered).
      ground: optional GROUND_NETWORKS key ("dense12", "mid4", "sparse1")
        replacing the preset's default station set.
      **overrides: ConstellationSpec fields to replace (min_elevation_deg,
        seed, ...).

    Returns the fully-resolved `ConstellationSpec`.
    """
    return CONSTELLATIONS.build(name, ground=ground, **overrides)
