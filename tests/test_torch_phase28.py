"""``chip_smoke.py`` phase 28 (the entry points the JAX suites hold)
rehearsed on the CPU at a small size, in the fresh interpreter the phase
runs in on the card, its own checks held: a CPU mesh with the device plane
engaged on it, ``p2p_copy``'s plain version counted in place of its
launches, 256 KiB DEVICE attachments, 64-token prompts (64 KiB of KV,
the plane's default threshold)."""
from __future__ import annotations

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase28_rehearsal_on_cpu():
    sys.path.insert(0, _REPO)
    import chip_smoke as cs
    r = cs.phase_entry_points(
        device="cpu", ENTRY_DEVICE_BYTES=256 << 10, ENTRY_DEVICE_CALLS=3,
        ENTRY_PROMPT=64, ENTRY_STEPS=4, ENTRY_BATCH_STEPS=200,
        ENTRY_INTERACTIVE_STEPS=4, ENTRY_LALB_CALLS=60)
    a, b, c = r["a"], r["b"], r["c"]
    assert a["start(0)"]["listen_endpoint"].startswith("0.0.0.0:")
    assert a["start('p28')"]["listen_endpoint"] == "mem://p28"
    assert a["start()"]["listen_endpoint"] == "mem://server"
    # request and response legs of each DEVICE echo ride the plane
    assert a["device_echo"]["launches"] == a["device_echo"]["transfers"] == 6
    six = b["six_bands"]
    assert six["pool_bands"] == six["scheduler_bands"] == 6
    assert six["pool_priorities"] == six["scheduler_priorities"] \
        == list(range(6))
    assert six["launches"] == six["loadkv_received"] == 6
    assert b["preempt_off"]["preempted"] == 0
    assert b["preempt_on"]["preempted"] >= 1
    for run in (b["preempt_off"], b["preempt_on"]):
        assert run["loads"]["launches"] == run["loads"]["loadkv_received"] == 3
    assert sum(c["calls_by_server"].values()) == 60
    assert sorted(c["describe"]) == ["ici://5", "ici://6", "ici://7"]
    assert r["launches"] == 6 + 6 + 3 + 3
    assert cs.phase28_summary(r).startswith("entry points: start(0) -> ")
