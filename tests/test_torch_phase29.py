"""``chip_smoke.py`` phase 29 (what the twins of the JAX main-path suites
repaired) rehearsed on the CPU at a small size, in the fresh interpreter
the phase runs in on the card, its own checks held: a CPU mesh with the
device plane engaged on it, ``p2p_copy``'s plain version counted in
place of its launches, 256 KiB DEVICE attachments and a 256 KiB big
stream frame (over the plane's and the stream's 64 KiB thresholds), the
fabric stream's peer a second CPU process."""
from __future__ import annotations

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase29_rehearsal_on_cpu():
    sys.path.insert(0, _REPO)
    import chip_smoke as cs
    r = cs.phase_twins(
        device="cpu", TWIN_ECHO_BYTES=256 << 10, TWIN_ECHO_CALLS=3,
        TWIN_STREAM_BIG=256 << 10, TWIN_HC_BYTES=256 << 10)
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    # request leg 2 -> 1 and response leg back, per call
    assert a["launches"] == a["transfers"] == 6
    assert a["resident_ranks"] == [1]
    assert a["device_bytes"] >= 3 * (256 << 10)
    assert b["one"]["launches"] == 1 and b["one"]["dst_rank"] == 5
    assert b["one"]["equal"]
    assert b["reap"]["match_timeouts"] == 1 and b["reap"]["recv_refused"]
    assert b["reap"]["next_rank"] == 7 and b["reap"]["launches"] == 1
    assert [f["launches"] for f in c["frames"]] == [0, 1, 0]
    assert c["threshold"] == 64 << 10
    fab = c["fabric"]
    assert fab["frames"] == [4 << 10, 256 << 10, 4 << 10]
    assert fab["received"] == 3 and fab["bad"] == 0
    assert sum(fab["fast_claimed"].values()) == 256 << 10
    assert (d["probe_down"], d["probe_up"]) == (False, True)
    assert d["fired"] == ["a", "b"]
    assert d["launches"] == d["transfers"] == 2
    assert r["launches"] == 6 + 2 + 1 + 2
    assert cs.phase29_summary(r).startswith("twins: ici echo 256 KiB x 3")
