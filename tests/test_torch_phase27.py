"""``chip_smoke.py`` phase 27 (the main path under both runtime layers of
the debug tooling) rehearsed on the CPU at a small size, in the fresh
interpreters the phase runs in on the card, its own checks held: a CPU
mesh with the device plane engaged on it, ``p2p_copy``'s plain version
counted in place of its launches, 256 KiB attachments and chunks, a
64-token session and a fabric_peer under both layers."""
from __future__ import annotations

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase27_rehearsal_on_cpu():
    sys.path.insert(0, _REPO)
    import chip_smoke as cs
    r = cs.phase_debug_layers(
        device="cpu", DEBUG_ECHO_CALLS=30, DEBUG_ECHO_BYTES=256 << 10,
        DEBUG_PROMPT=64, DEBUG_STEPS=4, DEBUG_STREAM_CHUNKS=4,
        DEBUG_STREAM_CHUNK=256 << 10, DEBUG_FABRIC_CALLS=4,
        DEBUG_FABRIC_BYTES=256 << 10)
    off, on = r["off"], r["on"]
    # the off process ran with both layers off: no DebugLock was taken
    assert off["in_process"]["nodes"] == 0 and "serving" not in off
    # the on process: every report ok, a real graph, nothing left held
    for rep in (on["reports"], on["fabric"]["peer_reports"]):
        assert rep["cycles"] == rep["long_holds"] == 0
        assert rep["outstanding"] == rep["unmatched"] == 0
        assert rep["nodes"] > 0
    assert on["in_process"]["nodes"] == on["reports"]["nodes"]
    # plain copies counted in place of launches, path by path
    assert on["echo"]["launches"] == on["echo"]["transfers"] == 80
    assert on["serving"]["launches"] == on["serving"]["loadkv_received"] == 1
    assert on["stream"]["launches"] == on["stream"]["equal"] == 4
    assert on["fabric"]["this_process"]["launches"] == 4
    assert on["fabric"]["peer"]["launches"] == 4
    assert r["launches"] == off["launches"] + on["launches"]
    assert set(r["echo_p50_us"]) == {"layers_off", "layers_on"}
    assert r["fablint"].startswith("fablint: 0 finding(s) [all]")
    assert cs.phase27_summary(r).startswith("debug layers: echo 256 KiB ")
