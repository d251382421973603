"""Redis protocol: RESP client + server.

Reference: src/brpc/policy/redis_protocol.cpp + redis.{h,cpp},
redis_command.cpp, redis_reply.cpp — the client speaks RESP with command
pipelining (multiple commands per RedisRequest, responses correlated by
arrival order, socket.h:256-262 pipelined_count); the server side
(RedisService) lets a brpc server answer redis-cli directly, dispatching on
the command name.  The codec, the parser's verdicts and the bytes each side
writes are those of the JAX package's ``policy/redis.py``, so either
package's client talks to the other's server.  Both ends keep a
connection's order across the messenger's concurrent per-message dispatch:
a client's replies claim their calls in the reader, in arrival order, and a
server writes each batch's replies after every earlier batch's
(``process_inline``).

Usage, client:
    ch.init(target, options=ChannelOptions(protocol="redis"))
    req = RedisRequest(); req.add_command("SET", "k", "v")
    resp = ch.call_method("redis", cntl, req, RedisResponse)

Usage, server:
    class MyRedis(RedisService):
        def __init__(self):
            super().__init__()
            self.add_handler("GET", lambda args: self.data.get(args[0]))
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..butil.iobuf import IOBuf
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import Protocol, ParseResult, register_protocol
from . import ordered

# ---- RESP codec -------------------------------------------------------

REPLY_STATUS = "status"
REPLY_ERROR = "error"
REPLY_INTEGER = "integer"
REPLY_BULK = "bulk"
REPLY_ARRAY = "array"
REPLY_NIL = "nil"


class RedisReply:
    __slots__ = ("type", "value")

    def __init__(self, type_: str, value: Any = None):
        self.type = type_
        self.value = value

    def is_error(self) -> bool:
        return self.type == REPLY_ERROR

    def __repr__(self) -> str:
        return f"RedisReply({self.type}, {self.value!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, RedisReply):
            return (self.type, self.value) == (other.type, other.value)
        return self.value == other


def encode_command(*args) -> bytes:
    """RESP array-of-bulk-strings encoding."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, (int, float)):
            a = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


def encode_reply(value: Any) -> bytes:
    """Python value → RESP reply bytes."""
    if isinstance(value, RedisReply):
        if value.type == REPLY_STATUS:
            return b"+%s\r\n" % str(value.value).encode()
        if value.type == REPLY_ERROR:
            return b"-%s\r\n" % str(value.value).encode()
        value = value.value
    if value is None:
        return b"$-1\r\n"
    if isinstance(value, bool):
        return b":%d\r\n" % int(value)
    if isinstance(value, int):
        return b":%d\r\n" % value
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, (bytes, bytearray)):
        return b"$%d\r\n%s\r\n" % (len(value), bytes(value))
    if isinstance(value, (list, tuple)):
        return b"*%d\r\n" % len(value) + b"".join(
            encode_reply(v) for v in value)
    raise TypeError(f"cannot encode {type(value)} as RESP")


def _parse_one(data: bytes, pos: int) -> Optional[Tuple[RedisReply, int]]:
    """Parse one reply at pos; None if incomplete."""
    if pos >= len(data):
        return None
    line_end = data.find(b"\r\n", pos)
    if line_end < 0:
        return None
    marker = data[pos:pos + 1]
    line = data[pos + 1:line_end]
    nxt = line_end + 2
    if marker == b"+":
        return RedisReply(REPLY_STATUS, line.decode()), nxt
    if marker == b"-":
        return RedisReply(REPLY_ERROR, line.decode()), nxt
    if marker == b":":
        return RedisReply(REPLY_INTEGER, int(line)), nxt
    if marker == b"$":
        n = int(line)
        if n < 0:
            return RedisReply(REPLY_NIL), nxt
        if len(data) < nxt + n + 2:
            return None
        return RedisReply(REPLY_BULK, data[nxt:nxt + n]), nxt + n + 2
    if marker == b"*":
        n = int(line)
        if n < 0:
            return RedisReply(REPLY_NIL), nxt
        items = []
        for _ in range(n):
            r = _parse_one(data, nxt)
            if r is None:
                return None
            item, nxt = r
            items.append(item)
        return RedisReply(REPLY_ARRAY, items), nxt
    raise ValueError(f"bad RESP marker {marker!r}")


# ---- request/response objects ----------------------------------------

class RedisRequest:
    def __init__(self):
        self._commands: List[bytes] = []
        self.command_names: List[str] = []

    def add_command(self, *args) -> None:
        self._commands.append(encode_command(*args))
        self.command_names.append(str(args[0]).upper())

    def command_count(self) -> int:
        return len(self._commands)

    def serialize(self) -> bytes:
        return b"".join(self._commands)


class RedisResponse:
    def __init__(self):
        self.replies: List[RedisReply] = []

    def reply(self, i: int = 0) -> RedisReply:
        return self.replies[i]

    def reply_count(self) -> int:
        return len(self.replies)


# ---- client side ------------------------------------------------------

class _PipelinedRedisCtx:
    __slots__ = ("cid", "expected", "replies", "auth_skip")

    def __init__(self, cid: int, expected: int):
        self.auth_skip = 0
        self.cid = cid
        self.expected = expected
        self.replies: List[RedisReply] = []


class _Bundle(list):
    """One read's RESP units, in order: a server's pipelined commands or
    a client's replies.  The reader numbers a server's bundle in its
    connection's order (``seq``) and hands a client's replies to their
    calls (``done``: the contexts they completed)."""
    __slots__ = ("is_request", "seq", "done")

    def __init__(self, units, is_request: bool):
        super().__init__(units)
        self.is_request = is_request
        self.seq = None
        self.done = ()


def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    """Cut ALL complete RESP units into ONE bundle.  Unlike tpu_std frames
    (independent, processed concurrently), pipelined redis commands must be
    handled strictly in order — bundling keeps the batch on one processor
    (the reference's redis server consumes command batches serially too)."""
    data = source.fetch(len(source))
    if not data:
        return ParseResult.not_enough_data()
    if data[:1] not in b"+-:$*":
        return ParseResult.try_others()
    # RESP's markers are single bytes that collide with binary frames (e.g.
    # '$' = 0x24 is a plausible little-endian mongo length); only claim the
    # stream when redis is actually in play here — server side: a
    # RedisService is registered; client side: a redis call is outstanding
    # (the reference gates server protocols on enabled services too)
    server = getattr(arg, "server", None)
    if server is not None:
        if getattr(server, "redis_service", None) is None:
            return ParseResult.try_others()
    elif not getattr(socket, "pipelined_contexts", None):
        return ParseResult.try_others()
    units: List[RedisReply] = []
    pos = 0
    try:
        while pos < len(data):
            r = _parse_one(data, pos)
            if r is None:
                break
            reply, pos = r
            units.append(reply)
    except (ValueError, IndexError) as e:
        return ParseResult.parse_error(str(e))
    if not units:
        return ParseResult.not_enough_data()
    source.pop_front(pos)
    return ParseResult.ok(_Bundle(units, server is not None))


def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    buf = IOBuf()
    if isinstance(request, RedisRequest):
        buf.append(request.serialize())
        cntl._redis_expected = request.command_count()
    elif isinstance(request, (list, tuple)):
        buf.append(encode_command(*request))
        cntl._redis_expected = 1
    else:
        raise TypeError("redis request must be RedisRequest or arg tuple")
    return buf


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    out = IOBuf()
    # RedisAuthenticator (policy/redis_authenticator.cpp): AUTH precedes
    # the first command on each connection; its +OK is consumed by the
    # response path via ctx.auth_skip, never surfaced to the user
    sock = getattr(cntl, "_pack_socket", None)
    cntl._redis_auth_skip = 0
    if cntl.auth_token and sock is not None and \
            not getattr(sock, "_redis_authed", False):
        sock._redis_authed = True
        out.append(encode_command("AUTH", *cntl.auth_token.split("\x00")))
        cntl._redis_auth_skip = 1
    out.append(payload)
    return out


def process_inline(bundle: _Bundle, socket) -> bool:
    """Runs in the reader, in cut order: a server's batch takes its place
    in the connection's reply order, and a client's replies go to the
    oldest outstanding calls (one call may span several reads)."""
    if bundle.is_request:
        bundle.seq = ordered.number(socket)
        return False
    done = []
    with socket._pipeline_lock:
        ctxs = socket.pipelined_contexts
        for msg in bundle:
            if not ctxs:
                break
            ctx = ctxs[0]
            ctx.replies.append(msg)
            if len(ctx.replies) >= ctx.expected:
                done.append(ctxs.pop(0))
    bundle.done = done
    return False


def process_response(bundle: _Bundle, socket) -> None:
    """Completes the calls whose replies the reader gathered."""
    from ..bthread import id as bthread_id
    for ctx in bundle.done:
        rc, cntl = bthread_id.lock(ctx.cid)
        if rc != 0 or cntl is None:
            continue
        auth_replies, user_replies = (ctx.replies[:ctx.auth_skip],
                                      ctx.replies[ctx.auth_skip:])
        if any(r.is_error() for r in auth_replies):
            socket._redis_authed = False
            cntl.set_failed(errors.ERPCAUTH,
                            f"redis AUTH failed: {auth_replies[0].value}")
        resp = RedisResponse()
        resp.replies = user_replies
        cntl.response = resp
        cntl.remote_side = socket.remote_side
        cntl.finish_parsed_response(ctx.cid)


# ---- server side ------------------------------------------------------

class RedisService:
    """Server-side redis dispatcher (reference RedisService): register
    command handlers; unknown commands get -ERR."""

    def __init__(self):
        self._handlers: Dict[str, Callable[[List[bytes]], Any]] = {}
        self.add_handler("PING", lambda args: RedisReply(REPLY_STATUS, "PONG"))
        self.add_handler("COMMAND", lambda args: [])

    def add_handler(self, command: str,
                    fn: Callable[[List[bytes]], Any]) -> None:
        self._handlers[command.upper()] = fn

    def dispatch(self, command: List[RedisReply]) -> bytes:
        if not command:
            return encode_reply(RedisReply(REPLY_ERROR, "ERR empty command"))
        parts = [c.value if isinstance(c.value, (bytes, bytearray))
                 else str(c.value).encode() for c in command]
        name = parts[0].decode().upper()
        fn = self._handlers.get(name)
        if fn is None:
            return encode_reply(RedisReply(
                REPLY_ERROR, f"ERR unknown command '{name}'"))
        try:
            return encode_reply(fn(parts[1:]))
        except Exception as e:
            return encode_reply(RedisReply(REPLY_ERROR, f"ERR {e}"))


def process_request(bundle: _Bundle, socket, server) -> None:
    svc = getattr(server, "redis_service", None)
    out = []
    try:
        if svc is None:
            out.append(encode_reply(RedisReply(
                REPLY_ERROR, "ERR this server has no RedisService")))
            return
        for msg in bundle:      # strict order within the pipeline batch
            if msg.type == REPLY_ARRAY:
                out.append(svc.dispatch(msg.value))
            else:               # inline command
                parts = [RedisReply(REPLY_BULK, p) for p in bytes(
                    msg.value if isinstance(msg.value, (bytes, bytearray))
                    else str(msg.value).encode()).split()]
                out.append(svc.dispatch(parts))
    finally:
        # every numbered batch answers once, or the connection's later
        # replies would wait behind it forever
        ordered.write(socket, bundle.seq, IOBuf(b"".join(out)))


def _make_pipeline_ctx(cid: int, cntl: Controller) -> _PipelinedRedisCtx:
    skip = getattr(cntl, "_redis_auth_skip", 0)
    ctx = _PipelinedRedisCtx(cid,
                             getattr(cntl, "_redis_expected", 1) + skip)
    ctx.auth_skip = skip
    return ctx


PROTOCOL = Protocol(
    name="redis",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_inline=process_inline,
    pipelined=True,
    make_pipeline_ctx=_make_pipeline_ctx,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("redis") is None:
        register_protocol(PROTOCOL)


_register()
