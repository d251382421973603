"""Load-aware prefill→decode routing over the LALB divided-weight balancer.

Port of :mod:`brpc_tpu.serving.router`.  The router must KNOW which
decode worker it chose (the prefill worker pushes the KV to that
endpoint) and feed the decode call's outcome back so a slow or failing
worker's weight collapses within one request time:

  * membership — an explicit target list, added to and removed from by
    the caller (``add_target`` / ``remove_target``, the autoscaler's
    registration surface), or a naming url (``pod://``, ``mesh://``,
    ``list://``) re-resolved on a poll thread, so a pod's advertise and
    withdraw transitions reach the balancer within one refresh interval;
  * selection — ``pick()`` = LALB ``select_server`` + a per-call exclusion
    list, so a retry after a dead worker never re-picks it;
  * feedback — ``feedback(url, error_code, latency_us)`` closes the loop;
  * session affinity — ``bind_session`` / ``session_url`` / ``rebind`` /
    ``unbind``: a live session routes by session, and ``rebind`` is a
    migration's cutover, one dict write under the lock.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from ..butil.endpoint import parse_endpoint
from ..policy.load_balancers import LocalityAwareLB


class LoadAwareRouter:
    """LALB selection + channel cache for a router service.  Thread-safe.
    ``rng`` draws the weighted selections (a seeded ``random.Random``
    makes them reproducible)."""

    # session-affinity cardinality cap: session ids are wire input
    MAX_BOUND_SESSIONS = 8192

    def __init__(self, targets, channel_options=None,
                 rng: Optional[random.Random] = None,
                 refresh_interval_s: float = 0.5):
        """``targets``: a list of decode worker urls, a comma-separated
        string of them, or a naming url whose membership a refresher
        thread re-reads every ``refresh_interval_s``."""
        from .. import rpc
        self._copts = channel_options or rpc.ChannelOptions(
            timeout_ms=60000)
        self._lock = threading.Lock()
        self._lb = LocalityAwareLB(rng)
        self._channels: Dict[str, object] = {}
        self._picks: Dict[str, int] = {}
        # session -> decode worker url: a reader sees the old worker or
        # the new one, never neither
        self._affinity: Dict[str, str] = {}
        self._rebinds = 0
        self._closed = False
        self._refresher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._naming_url: Optional[str] = None
        from ..policy.naming import is_naming_url
        if isinstance(targets, str) and is_naming_url(targets):
            self._naming_url = targets
            self._refresh_interval_s = refresh_interval_s
            self._refresh_once()
            t = threading.Thread(target=self._refresh_loop,
                                 name="serving_router_refresh", daemon=True)
            with self._lock:
                self._refresher = t
            t.start()
            return
        if isinstance(targets, str):
            targets = [t for t in targets.split(",") if t]
        for url in targets:
            self.add_target(url)

    # ---- membership ----------------------------------------------------
    def add_target(self, url: str) -> bool:
        return self._lb.add_server(parse_endpoint(url))

    def remove_target(self, url: str) -> bool:
        """Take a decode worker out of selection and close its channel
        (the autoscaler's scale-down).  Every channel to the endpoint
        shares one connection, so the close fails the calls already
        issued to it with ECLOSE, and their callers retry them elsewhere;
        they do not complete on the removed worker."""
        ep = parse_endpoint(url)
        ok = self._lb.remove_server(ep)
        with self._lock:
            ch = self._channels.pop(str(ep), None)
        if ch is not None:
            ch.close()
        return ok

    def targets(self) -> List[str]:
        return [str(e.endpoint) for e in self._lb.servers()]

    def _refresh_once(self) -> None:
        """Make the balancer's members the naming url's servers."""
        from ..policy.naming import create_naming_service
        try:
            entries = create_naming_service(self._naming_url).get_servers()
        except Exception:
            return
        fresh = {e.endpoint for e in entries}
        have = {e.endpoint for e in self._lb.servers()}
        for ep in fresh - have:
            self._lb.add_server(ep)
        for ep in have - fresh:
            self.remove_target(str(ep))

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self._refresh_interval_s):
            self._refresh_once()

    # ---- selection / feedback ------------------------------------------
    def pick(self, exclude: Optional[set] = None) -> Optional[str]:
        """Choose a decode worker by divided weight; ``exclude`` carries
        the endpoints a retry already burned."""
        if exclude:
            excl_eps = {parse_endpoint(u) for u in exclude}
            ep = None
            for _ in range(8):
                cand = self._lb.select_server()
                if cand is None or cand not in excl_eps:
                    ep = cand
                    break
                # a discarded draw must retire its in-flight entry
                self._lb.cancel_inflight(cand)
            if ep is None:
                # the weighted draw kept landing on excluded workers: a
                # retry must still reach ANY remaining member
                for e in self._lb.servers():
                    if e.endpoint not in excl_eps:
                        ep = e.endpoint
                        break
        else:
            ep = self._lb.select_server()
        if ep is None:
            return None
        url = str(ep)
        with self._lock:
            self._picks[url] = self._picks.get(url, 0) + 1
        return url

    def channel(self, url: str):
        from .. import rpc
        with self._lock:
            if self._closed:
                raise RuntimeError("router closed")
            ch = self._channels.get(url)
            if ch is None:
                ch = rpc.Channel()
                ch.init(url, options=self._copts)
                self._channels[url] = ch
            return ch

    def feedback(self, url: str, error_code: int, latency_us: int) -> None:
        self._lb.feedback(parse_endpoint(url), error_code, latency_us)

    def weight_of(self, url: str) -> float:
        return self._lb.weight_of(parse_endpoint(url))

    # ---- session affinity (the migration cutover) ----------------------
    def bind_session(self, session: str, url: str) -> None:
        """Pin a live session to the decode worker holding its KV, so
        follow-up decodes route by session, not by weight."""
        with self._lock:
            while len(self._affinity) >= self.MAX_BOUND_SESSIONS:
                self._affinity.pop(next(iter(self._affinity)))
            self._affinity[session] = url

    def session_url(self, session: str) -> Optional[str]:
        with self._lock:
            return self._affinity.get(session)

    def rebind(self, session: str, url: str) -> Optional[str]:
        """The cutover: point a session's affinity at the migration
        destination.  Returns the previous binding (None if unbound)."""
        with self._lock:
            prev = self._affinity.get(session)
            while session not in self._affinity \
                    and len(self._affinity) >= self.MAX_BOUND_SESSIONS:
                self._affinity.pop(next(iter(self._affinity)))
            self._affinity[session] = url
            if prev is not None and prev != url:
                self._rebinds += 1
            return prev

    def unbind(self, session: str) -> None:
        with self._lock:
            self._affinity.pop(session, None)

    # ---- lifecycle / observability --------------------------------------
    def close(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._refresher = self._refresher, None
            self._closed = True
            chans, self._channels = list(self._channels.values()), {}
        if t is not None and t is not threading.current_thread():
            t.join(2.0)
        for ch in chans:
            ch.close()

    def describe(self) -> dict:
        """The /status serving block's routing half: divided weights +
        pick distribution per decode worker."""
        with self._lock:
            picks = dict(self._picks)
            bound = len(self._affinity)
            rebinds = self._rebinds
        weights = {str(e.endpoint): round(self._lb.weight_of(e.endpoint), 1)
                   for e in self._lb.servers()}
        return {"balancer": "la", "weights": weights, "picks": picks,
                "sessions_bound": bound, "rebinds": rebinds,
                "naming": self._naming_url or "static"}
