"""A window's two transfer halves: the order in which faults, inter-
satellite links and link budgets compose around the ground segment's
upload and download.

`SimulationEngine`'s host loop (one run, (K,) operands) and the sweep's
window loop (a group of variants, (V, K) operands) both call these, so the
order lives in one place:

  upload: revival (`fault_reset`); then either the sink relay (advance the
  ring, route through the sink's contact, dead satellites off that path,
  the sink's grants) or a gossip exchange; then `upload_step`.
  download: under sink relaying, the sink's contact for the satellites
  whose update has arrived (dead ones fetch nothing) and a relay reset
  where a fresh round starts; otherwise `download_step` on the window's
  own connectivity.

Every operand is a device tensor (or None for a layer the run does not
model); nothing here reads the device.
"""
from __future__ import annotations

from repro_torch.core import faults as FT
from repro_torch.core import isl as ISL
from repro_torch.core import staleness as SS


def sink_gate(gate, sink):
    """The link gate gathered at each satellite's sink: the plane's
    transfer rides the sink's contact units (None passes through)."""
    if gate is None:
        return None
    return gate._replace(grant=ISL._take(gate.grant, sink))


def window_upload(state, ig, conn, gate=None, *, revive=None, alive=None,
                  sink=None, need_hops=None, gossip=None):
    """The upload half of a window. `revive`/`alive` are a fault run's
    masks, `sink`/`need_hops` the window's sink plan (sink relaying),
    `gossip` the neighbour arrays and the hop flag ``(nxt, prv, left,
    right, do_hop)`` (a gossip run, on a hop window); each None when the
    run does not model it. Returns `upload_step`'s ``(state, info)``."""
    if revive is not None:
        state = FT.fault_reset(state, revive)
    if sink is not None:
        state, arrived = ISL.relay_step(state, need_hops)
        conn = ISL.sink_connectivity(conn, sink, arrived, state.pending)
        if alive is not None:
            conn = conn & alive
        gate = sink_gate(gate, sink)
    elif gossip is not None:
        state, _ = ISL.gossip_step(state, *gossip, alive)
    return SS.upload_step(state, ig, conn, gate)


def window_download(state, ig, conn, gate=None, *, alive=None, sink=None,
                    need_hops=None):
    """The download half of a window (after the aggregation), with the
    operands of `window_upload`: no relay advance, the upload advanced it
    already. Returns the new state."""
    if sink is None:
        return SS.download_step(state, ig, conn, gate)[0]
    eff = ISL.sink_connectivity(conn, sink, state.relay >= need_hops,
                                state.pending)
    if alive is not None:
        eff = eff & alive
    state, dn = SS.download_step(state, ig, eff, sink_gate(gate, sink))
    return ISL.reset_relay(state, dn["downloads"])
