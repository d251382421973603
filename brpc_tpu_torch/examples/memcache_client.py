"""A memcache binary-protocol client (example/memcache_c++) against a
minimal memcached (get and set) served in this process on ``mem://``, so
the example needs nothing else; point the target at a real memcached to
split them.

    python -m brpc_tpu_torch.examples.memcache_client            # card
    python -m brpc_tpu_torch.examples.memcache_client --device cpu
"""
from __future__ import annotations

import struct
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.examples.common import parse_device, setup_mesh
from brpc_tpu_torch.policy import memcache as mc
from brpc_tpu_torch.rpc.input_messenger import InputMessenger
from brpc_tpu_torch.rpc.mem_transport import mem_listen, mem_unlisten
from brpc_tpu_torch.rpc.protocol import ParseResult, Protocol

NAME = "memcache-example"


def start_backend(name: str):
    """A memcached on ``mem://name`` that answers binary get and set."""
    data = {}

    def handle(frame: bytes) -> bytes:
        (_magic, opcode, keylen, extraslen, _dt, _vb, bodylen, opaque,
         cas) = mc._HDR.unpack(frame[:24])
        body = frame[24:24 + bodylen]
        key = body[extraslen:extraslen + keylen]
        value = body[extraslen + keylen:]
        status, rextras, rvalue = mc.STATUS_OK, b"", b""
        if opcode == mc.OP_SET:
            data[key] = value
        elif opcode == mc.OP_GET:
            if key in data:
                rextras, rvalue = struct.pack(">I", 0), data[key]
            else:
                status = mc.STATUS_KEY_NOT_FOUND
        return mc._HDR.pack(mc.MAGIC_RESPONSE, opcode, 0, len(rextras), 0,
                            status, len(rextras) + len(rvalue), opaque,
                            cas) + rextras + rvalue

    def parse(source, socket, read_eof, arg):
        raw = source.fetch(len(source)) or b""
        frames, pos = [], 0
        while pos + 24 <= len(raw):
            bodylen = mc._HDR.unpack(raw[pos:pos + 24])[6]
            if pos + 24 + bodylen > len(raw):
                break
            frames.append(raw[pos:pos + 24 + bodylen])
            pos += 24 + bodylen
        if not frames:
            return ParseResult.not_enough_data()
        source.pop_front(pos)
        return ParseResult.ok(frames)

    def process(frames, socket, server):
        socket.write(IOBuf(b"".join(handle(f) for f in frames)))

    messenger = InputMessenger(
        protocols=[Protocol(name="mini_mc", parse=parse,
                            process_request=process)],
        server=object())
    return mem_listen(name, lambda s: setattr(s, "messenger", messenger))


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    start_backend(NAME)
    ch = rpc.Channel()
    try:
        ch.init(f"mem://{NAME}", options=rpc.ChannelOptions(
            protocol="memcache", timeout_ms=2000))
        req = mc.MemcacheRequest()
        req.set("answer", b"42")
        req.get("answer")
        req.get("missing")
        cntl = rpc.Controller()
        resp = ch.call_method("memcache", cntl, req, None)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        print("memcache -> set ok, get:", resp.op(1).value,
              "miss status:", resp.op(2).status)
        return 0 if (resp.op(1).value == b"42" and resp.op(2).status
                     == mc.STATUS_KEY_NOT_FOUND) else 1
    finally:
        ch.close()
        mem_unlisten(NAME)


if __name__ == "__main__":
    sys.exit(main())
