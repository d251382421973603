"""InputMessenger: read → cut messages → dispatch, one tasklet per message.

Reference: src/brpc/input_messenger.{h,cpp} (CutInputMessage at :64,
OnNewMessages at :317, QueueMessage at :169).  Reads the transport until
EAGAIN, tries registered protocols to cut complete messages (remembering the
first protocol that succeeds per socket), then dispatches every message in
its own tasklet — the request-isolation doctrine: a slow handler only slows
its own request.  A protocol's order-sensitive messages (stream frames) are
consumed in the reader instead, in cut order (``Protocol.process_inline``).
A server with ``usercode_in_pthread`` hands requests to its backup thread
pool instead, counted from submission so the lame-duck drain sees a request
still queued behind a busy pool.
"""
from __future__ import annotations

from typing import Any, List, Optional

from ..bthread import scheduler
from . import errors
from .protocol import ParseResultType, Protocol, list_protocols


class InputMessenger:
    def __init__(self, protocols: Optional[List[Protocol]] = None,
                 server=None):
        # the protocols this messenger tries, in order (None: every
        # registered one)
        self._protocols = protocols
        self.server = server                 # set for server-side messengers

    def protocols(self) -> List[Protocol]:
        """The protocols this messenger tries, in order."""
        return self._protocols if self._protocols is not None \
            else list_protocols()

    # called from Socket._process_event (single reader per socket)
    def on_new_messages(self, socket):
        """Read until EAGAIN, cut messages, dispatch all but the last to
        their own tasklets, and RETURN the last one (already cut from the
        buffer).  The socket releases readership before processing it in
        place (input_messenger.cpp:205-311 + the socket.cpp:2046 single-
        reader discipline)."""
        read_eof = False
        last = None
        # inbox-backed transports advertise a large hint because their
        # _do_read only CUTS already-resident bytes
        read_max = getattr(socket, "read_chunk_hint", 1 << 16)
        while not read_eof and not socket.failed:
            nr = socket._do_read(socket._read_portal, read_max)
            if nr < 0:
                break                         # EAGAIN: wait for next event
            if nr == 0:
                read_eof = True               # remote closed: parse leftovers
            socket.stat.in_size += max(nr, 0)
            msgs = self._cut_messages(socket)
            if msgs is None:                  # corrupt stream
                socket.set_failed(errors.EREQUEST, "protocol parse error")
                return None
            if last is not None:              # previous batch's holdover
                self._queue_message(*last, socket)
                last = None
            for proto, msg in msgs[:-1]:
                self._queue_message(proto, msg, socket)
            if msgs:
                last = msgs[-1]
        if read_eof:
            if last is not None:
                self._queue_message(*last, socket)
                last = None
            # a peer that closed with an explicit code (a server's
            # lame-duck ELOGOFF) surfaces it here, AFTER the queued
            # responses above were handled: an executed call completes,
            # only the unanswered ones see the retryable code
            code = socket._eof_error_code or errors.EEOF
            socket.set_failed(code, "remote closed")
        return last

    def process_in_place(self, last, socket) -> None:
        proto, msg = last
        self._process_message(proto, msg, socket)

    def _cut_messages(self, socket) -> Optional[list]:
        out = []
        protocols = self._protocols
        if protocols is None:
            protocols = list_protocols()
        while len(socket._read_portal):
            result = None
            if socket._selected_protocol_index >= 0:
                proto = protocols[socket._selected_protocol_index]
                result = proto.parse(socket._read_portal, socket, False, self)
                if result.type == ParseResultType.TRY_OTHERS:
                    socket._selected_protocol_index = -1
                    result = None
            if result is None:
                for i, proto in enumerate(protocols):
                    result = proto.parse(socket._read_portal, socket, False, self)
                    if result.type in (ParseResultType.OK,
                                       ParseResultType.NOT_ENOUGH_DATA):
                        socket._selected_protocol_index = i
                        break
                else:
                    return None               # nobody recognizes the bytes
                proto = protocols[socket._selected_protocol_index]
            if result.type == ParseResultType.NOT_ENOUGH_DATA:
                break
            if result.type == ParseResultType.ERROR:
                return None
            socket.stat.in_num_messages += 1
            # order-sensitive messages (stream frames) are consumed here,
            # in cut order, before per-message dispatch could reorder them
            if proto.process_inline is not None and proto.process_inline(
                    result.message, socket):
                continue
            out.append((proto, result.message))
        return out

    def _queue_message(self, proto: Protocol, msg: Any, socket) -> None:
        scheduler.start_background(self._process_message, proto, msg, socket,
                                   name="msg")

    def _process_message(self, proto: Protocol, msg: Any, socket) -> None:
        pool = getattr(self.server, "usercode_pool", None) \
            if self.server is not None else None
        if pool is not None and proto.process_request is not None:
            self.server.on_usercode_queued()
            try:
                pool.submit(self._run_usercode, proto, msg, socket)
                return
            except RuntimeError:
                # the pool shut down mid-stop: run here
                self.server.on_usercode_done()
        self._process_message_inline(proto, msg, socket)

    def _run_usercode(self, proto: Protocol, msg: Any, socket) -> None:
        try:
            self._process_message_inline(proto, msg, socket)
        finally:
            self.server.on_usercode_done()

    def _process_message_inline(self, proto: Protocol, msg: Any,
                                socket) -> None:
        try:
            if self.server is not None and proto.process_request is not None:
                # the admin port (ServerOptions.internal_port) serves only
                # the HTTP builtin pages: any other protocol there would
                # bypass the service/admin split, so it is refused at the
                # one dispatch point every server protocol passes
                if getattr(socket, "internal_only", False) and \
                        proto.name != "http":
                    socket.set_failed(
                        errors.EREQUEST,
                        f"protocol {proto.name!r} refused on the "
                        "internal admin port")
                    return
                proto.process_request(msg, socket, self.server)
            elif proto.process_response is not None:
                proto.process_response(msg, socket)
        except Exception as e:
            from ..butil import logging as log
            log.error("message processing raised: %s", e, exc_info=True)
