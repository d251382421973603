"""trackme — library-version pings to a central bulletin server (port of
:mod:`brpc_tpu.rpc.trackme`).

Reference: src/brpc/trackme.cpp (TrackMe() at :36; pings are sent from a
dedicated channel on server start and then every `interval` seconds; the
server can answer with a severity + bulletin text + new interval).  The
reference ships pointing at a Baidu-internal address and is disabled
outside; this build keeps the capability but is OFF unless the
``trackme_server`` flag names a server (tools/trackme_server.py is the
receiving end, mirroring tools/trackme_server/)."""
from __future__ import annotations

import threading
from typing import Optional

from ..butil import flags as _flags
from ..butil import logging as log
from ..proto.trackme_pb2 import (TrackMeRequest, TrackMeResponse,
                                 TRACKME_FATAL, TRACKME_OK, TRACKME_WARNING)

_flags.define_flag("trackme_server", "",
                   "address of the trackme bulletin server; empty = off")
_flags.define_flag("trackme_interval", 30,
                   "seconds between trackme pings")

RPC_VERSION = 1000          # bumped on wire-visible framework changes

_lock = threading.Lock()
_pinger: Optional["_Pinger"] = None
# the last bulletin a ping was answered with: (severity, text)
_last_bulletin: Optional[tuple] = None


class _Pinger:
    def __init__(self, target: str, server_addr: str):
        self.target = target
        self.server_addr = server_addr
        self._stop = threading.Event()
        self._channel = None
        # fablint: thread-quiesced(stop() sets _stop; the ping loop waits on it between pings and exits promptly)
        self._thread = threading.Thread(target=self._run,
                                        name="trackme", daemon=True)
        self._thread.start()

    def _ping_once(self) -> Optional[int]:
        from .channel import Channel, ChannelOptions
        from .controller import Controller
        ch = self._channel
        if ch is None:
            # one channel for the pinger's life, closed when it ends
            ch = self._channel = Channel()
            ch.init(self.target, options=ChannelOptions(timeout_ms=2000))
        cntl = Controller()
        req = TrackMeRequest(rpc_version=RPC_VERSION,
                             server_addr=self.server_addr)
        resp = ch.call_method("TrackMeService.TrackMe", cntl, req,
                              TrackMeResponse)
        if cntl.failed():
            return None
        global _last_bulletin
        if resp.severity != TRACKME_OK:
            _last_bulletin = (resp.severity, resp.error_text)
        if resp.severity == TRACKME_FATAL:
            log.error("trackme bulletin (FATAL): %s", resp.error_text)
        elif resp.severity == TRACKME_WARNING:
            log.warning("trackme bulletin: %s", resp.error_text)
        return resp.new_interval or None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                new_interval = self._ping_once()
            except Exception as e:
                log.warning("trackme ping failed: %s", e)
                new_interval = None
            interval = new_interval or _flags.get_flag("trackme_interval")
            if self._stop.wait(max(1, int(interval))):
                break
        if self._channel is not None:
            self._channel.close()

    def stop(self) -> None:
        self._stop.set()


def start_trackme(server_addr: str = "") -> bool:
    """Called on Server.start (trackme.cpp StartTrackMe); no-op unless
    the trackme_server flag is set.  Returns True when a pinger runs."""
    global _pinger
    target = _flags.get_flag("trackme_server")
    if not target:
        return False
    with _lock:
        if _pinger is None:
            _pinger = _Pinger(target, server_addr)
    return True


def stop_trackme() -> None:
    global _pinger
    with _lock:
        if _pinger is not None:
            _pinger.stop()
            _pinger = None


def last_bulletin() -> Optional[tuple]:
    """The last (severity, text) a ping was answered with, or None."""
    return _last_bulletin
