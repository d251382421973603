"""Pluggable wire-protocol contract + registry.

Reference: src/brpc/protocol.{h,cpp} (struct Protocol at protocol.h:77-196,
RegisterProtocol at :186).  A Protocol supplies parse (message cutting),
request/response serialization+packing, and server/client process callbacks.
InputMessenger tries registered protocols in order and remembers the first
that succeeds for a socket (protocol detection).
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..butil.iobuf import IOBuf


class ParseResultType(enum.Enum):
    OK = 0
    NOT_ENOUGH_DATA = 1     # keep buffering
    TRY_OTHERS = 2          # not this protocol
    ERROR = 3               # corrupt stream: kill the connection


@dataclass
class ParseResult:
    type: ParseResultType
    message: Any = None     # protocol-specific InputMessage when OK
    error: str = ""

    @staticmethod
    def ok(message: Any) -> "ParseResult":
        return ParseResult(ParseResultType.OK, message)

    @staticmethod
    def not_enough_data() -> "ParseResult":
        return ParseResult(ParseResultType.NOT_ENOUGH_DATA)

    @staticmethod
    def try_others() -> "ParseResult":
        return ParseResult(ParseResultType.TRY_OTHERS)

    @staticmethod
    def parse_error(msg: str = "") -> "ParseResult":
        return ParseResult(ParseResultType.ERROR, error=msg)


# connection types a protocol supports (reference
# connection_type.h): a bit each, or-ed in ``supported_connection_type``
CONNECTION_TYPE_SINGLE = 1
CONNECTION_TYPE_POOLED = 2
CONNECTION_TYPE_SHORT = 4
CONNECTION_TYPE_ALL = 7


@dataclass
class Protocol:
    name: str
    # parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult
    parse: Callable[[IOBuf, Any, bool, Any], ParseResult]
    # server side: process_request(msg, socket, server) — runs in a tasklet
    process_request: Optional[Callable[..., None]] = None
    # client side: process_response(msg, socket) — runs in a tasklet
    process_response: Optional[Callable[..., None]] = None
    # serialize_request(request_obj, controller) -> IOBuf (payload only)
    serialize_request: Optional[Callable[..., IOBuf]] = None
    # pack_request(payload: IOBuf, cid, controller, method) -> IOBuf
    pack_request: Optional[Callable[..., IOBuf]] = None
    # process_inline(msg, socket) -> bool: consume an order-sensitive
    # message (a stream frame) in the reader, in cut order; True when it
    # was consumed and must not be dispatched
    process_inline: Optional[Callable[[Any, Any], bool]] = None
    # the connection types a channel may ask for with this protocol
    supported_connection_type: int = CONNECTION_TYPE_ALL
    # the sides this protocol speaks (a server-only or client-only
    # variant says so here)
    support_client: bool = True
    support_server: bool = True
    # responses correlate by arrival order on the connection instead of
    # an id on the wire (HTTP/1.1, redis, memcache, the nshead family):
    # the channel queues each call's context on the socket, and a response
    # takes the oldest
    pipelined: bool = False
    # make_pipeline_ctx(cid, controller) -> the context a pipelined call
    # queues (a redis call's expected reply count, nshead's completion);
    # None queues the bare cid
    make_pipeline_ctx: Optional[Callable[[int, Any], Any]] = None


_protocols: List[Protocol] = []
_by_name: Dict[str, Protocol] = {}
_lock = threading.Lock()


def register_protocol(proto: Protocol) -> None:
    with _lock:
        if proto.name in _by_name:
            raise ValueError(f"protocol {proto.name!r} already registered")
        _protocols.append(proto)
        _by_name[proto.name] = proto


def list_protocols() -> List[Protocol]:
    with _lock:
        return list(_protocols)


def find_protocol(name: str) -> Optional[Protocol]:
    with _lock:
        return _by_name.get(name)
