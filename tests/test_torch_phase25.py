"""``chip_smoke.py`` phase 25 (TLS, the authenticators, the RTMP relay
with FLV and TS, trackme) rehearsed on the CPU at a small size in a fresh
interpreter, its own checks held: the DEVICE attachments are CPU tensors,
2 players take a 2 s stream, 20 echoes a leg."""
from __future__ import annotations

import json
import os
import subprocess
import sys

_PHASE25_CPU = r"""
import json, sys
sys.path.insert(0, %(repo)r)
import chip_smoke as cs
from brpc_tpu_torch.ici.p2p_copy import p2p_copy
cs.TLS_ECHOES, cs.TLS_DEVICE_CALLS, cs.TLS_DEVICE_BYTES = 20, 2, 1 << 20
cs.AUTH_ECHOES = 20
cs.RTMP_PLAYERS, cs.RTMP_SECONDS = 2, 2
r = cs.phase_tls_auth_media(device="cpu")
r["launches"] = p2p_copy.launches
foreign = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                 or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
r["foreign"] = foreign
r["summary"] = cs.phase25_summary(r)
sys.stdout.write("RESULT " + json.dumps(r) + "\n")
sys.stdout.flush()
"""


def test_phase25_rehearsal_on_cpu():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c",
                           _PHASE25_CPU % {"repo": repo}], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (
        f"rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    r = json.loads(lines[-1][len("RESULT "):])
    assert r["foreign"] == [] and r["launches"] == 0
    assert r["sockets_left"] == 0
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    assert a["echo_4k"]["tls"]["calls"] == a["echo_4k"]["tcp"]["calls"] == 20
    assert a["device_4m"]["tls"]["calls"] == a["device_4m"]["tcp"]["calls"] \
        == 2 and a["tls_after_refusal"] == 2
    assert a["plaintext_refused"]["code"] != 0
    assert b["wrong_token_code"] == 1004 and b["redis"] == {
        "auths": ["a", "b"], "connections": 2}
    assert b["memcache_sasl"] == {"right": 0, "wrong": 1004}
    for run in ("simple", "digest"):
        assert c[run]["messages"] == 1 + 60 + 86
        assert (c[run]["video"], c[run]["audio"]) == (60, 86)
        assert len(c[run]["players"]) == 2
    assert c["digest"]["digest"] and not c["simple"]["digest"]
    assert c["media"]["flv_tags"] == 147
    assert c["media"]["ts_bytes"] == 188 * c["media"]["ts_packets"]
    assert d["pings"] >= 2 and d["after_stop"] == 0
    assert r["summary"].startswith("tls/auth/rtmp/trackme: ")
