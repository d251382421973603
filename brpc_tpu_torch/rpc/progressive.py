"""Progressive attachment / progressive reader.

Reference: src/brpc/progressive_attachment.{h,cpp} + progressive_reader.h,
ported from :mod:`brpc_tpu.rpc.progressive` —
a server can keep appending body bytes after the response header went out
(large file download, incremental results); the client registers a reader
that consumes parts as they arrive.  The reference implements this with
chunked HTTP/raw socket writes; here it rides the stream machinery (same
wire as Streaming RPC), which gives flow control for free:

  client:  reader = ProgressiveReader(on_part, on_end)
           response_will_be_read_progressively(cntl, reader)   # before call
           ch.call_method(...)
  server:  pa = create_progressive_attachment(cntl)            # in handler
           done()                      # response goes out
           pa.append(b"...")           # as many times as needed
           pa.close()
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..butil.iobuf import IOBuf
from .stream import (Stream, StreamOptions, StreamInputHandler,
                     stream_create, stream_accept)


class ProgressiveReader:
    """Client-side part consumer (progressive_reader.h contract)."""

    def __init__(self,
                 on_part: Optional[Callable[[bytes], None]] = None,
                 on_end: Optional[Callable[[int], None]] = None):
        self._on_part = on_part
        self._on_end = on_end
        self.parts: List[bytes] = []
        self.ended = threading.Event()
        self.error_code = 0

    # overridable
    def on_read_one_part(self, data: bytes) -> None:
        self.parts.append(data)
        if self._on_part is not None:
            self._on_part(data)

    def on_end_of_message(self, error_code: int) -> None:
        self.error_code = error_code
        if self._on_end is not None:
            self._on_end(error_code)
        self.ended.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.ended.wait(timeout)

    def data(self) -> bytes:
        return b"".join(self.parts)


class _ReaderAdapter(StreamInputHandler):
    def __init__(self, reader: ProgressiveReader):
        self.reader = reader

    def on_received_messages(self, sid, msgs) -> None:
        for m in msgs:
            self.reader.on_read_one_part(m.to_bytes())

    def on_closed(self, sid) -> None:
        self.reader.on_end_of_message(0)


def response_will_be_read_progressively(cntl,
                                        reader: ProgressiveReader,
                                        max_buf_size: int = 2 << 20) -> None:
    """Client, before issuing the call (reference
    Controller::response_will_be_read_progressively)."""
    stream = stream_create(cntl, StreamOptions(
        handler=_ReaderAdapter(reader), max_buf_size=max_buf_size))
    cntl._progressive_stream = stream


class ProgressiveAttachment:
    """Server-side incremental body writer (progressive_attachment.h)."""

    def __init__(self, stream: Stream):
        self._stream = stream

    def append(self, data, timeout: Optional[float] = 10.0) -> int:
        """Blocking append honoring the stream window (0 ok)."""
        buf = data if isinstance(data, IOBuf) else IOBuf(data)
        return self._stream.write(buf, timeout=timeout)

    def close(self) -> None:
        self._stream.close()

    @property
    def closed(self) -> bool:
        return self._stream.closed


def create_progressive_attachment(cntl) -> Optional[ProgressiveAttachment]:
    """Server, inside the handler (before done()).  Returns None if the
    client didn't opt in."""
    stream = stream_accept(cntl, StreamOptions())
    return ProgressiveAttachment(stream)
