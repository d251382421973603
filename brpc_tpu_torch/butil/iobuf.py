"""IOBuf: zero-copy chained buffer — the universal payload type.

Reference: src/butil/iobuf.{h,cpp} (IOBuf/Block/BlockRef at iobuf.h:70-97,
append_user_data_with_meta at iobuf.h:253, IOPortal).

A Block is not always a host slab.  Three storage kinds share one BlockRef
chain:

  * HOST   — bytearray slab (default 8 KiB), appendable in place
  * USER   — externally-owned memory wrapped without copying
             (``append_user_data_with_meta``), with an optional deleter
  * DEVICE — a flat ``torch.uint8`` tensor owned by one logical rank of the
             mesh (``IciMesh.rank_of(block.data)`` names the rank; a slice
             of the tensor resolves to the same rank).  Appending one is a
             ref bump, never a transfer.  Host bytes are materialized only
             when a device ref crosses a host boundary (``to_bytes``): an
             explicit ``.cpu()`` copy.  The ici:// transport consumes device
             refs directly so payloads never leave device memory.

Cut/append/slice operations move BlockRefs, never bytes — same contract as
the reference.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, List, Optional, Union

DEFAULT_BLOCK_SIZE = 8192

# append() wraps immutable ``bytes`` at least this large as a USER block
# instead of copying into 8 KiB host slabs.  Only exact ``bytes`` qualify —
# bytearray/memoryview callers may mutate after append, and a shared ref
# would corrupt the buffer.
ZERO_COPY_BYTES_MIN = 16 * 1024

HOST = 0
USER = 1
DEVICE = 2


class Block:
    """Storage slab.  Lifetime is Python-GC-managed."""

    __slots__ = ("kind", "data", "size", "meta", "deleter", "_lock",
                 "on_send_complete")

    def __init__(self, kind: int, data: Any, meta: int = 0,
                 deleter: Optional[Callable[[Any], None]] = None,
                 size: Optional[int] = None):
        self.kind = kind
        self.data = data            # bytearray | memoryview | torch.Tensor
        self.size = size if size is not None \
            else (0 if kind == HOST else len(data))
        self.meta = meta
        self.deleter = deleter
        self._lock = threading.Lock() if kind == HOST else None
        # DEVICE blocks: invoked by the transport once an outbound transfer
        # sourced from this block completed — the earliest point the block
        # may be reused (rdma_endpoint.cpp:926 frees _sbuf refs on CQ
        # completion)
        self.on_send_complete: Optional[Callable[[], None]] = None

    @property
    def cap(self) -> int:
        return len(self.data)

    def left_space(self) -> int:
        return len(self.data) - self.size if self.kind == HOST else 0

    def host_view(self, offset: int, length: int) -> memoryview:
        """A memoryview of [offset, offset+length).  DEVICE blocks copy to
        the host here — the only place a device->host copy can happen.  A
        ``tcp://`` socket (the DCN path, not the device plane) and a
        fabric frame below the plane's threshold send DEVICE bytes this
        way, as the JAX package's do."""
        if self.kind == DEVICE:
            part = self.data[offset:offset + length]
            return memoryview(part.cpu().numpy().tobytes())
        return memoryview(self.data)[offset:offset + length]

    def __del__(self):
        if self.deleter is not None:
            try:
                self.deleter(self.data)
            except Exception:
                pass


def new_host_block(size: int = DEFAULT_BLOCK_SIZE) -> Block:
    return Block(HOST, bytearray(size))


class BlockRef:
    __slots__ = ("block", "offset", "length")

    def __init__(self, block: Block, offset: int, length: int):
        self.block = block
        self.offset = offset
        self.length = length


class IOBuf:
    """Chained zero-copy buffer."""

    __slots__ = ("_refs", "_size")

    def __init__(self, data: Union[bytes, bytearray, str, "IOBuf", None] = None):
        self._refs: List[BlockRef] = []
        self._size = 0
        if data is not None:
            self.append(data)

    # ---- size & repr -------------------------------------------------
    def __len__(self) -> int:
        return self._size

    def size(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    def backing_block_num(self) -> int:
        return len(self._refs)

    def backing_block(self, i: int) -> BlockRef:
        return self._refs[i]

    def __repr__(self) -> str:
        return f"IOBuf(size={self._size}, blocks={len(self._refs)})"

    def __eq__(self, other) -> bool:
        if isinstance(other, (bytes, bytearray)):
            return self.to_bytes() == bytes(other)
        if isinstance(other, IOBuf):
            return self.to_bytes() == other.to_bytes()
        return NotImplemented

    # ---- append ------------------------------------------------------
    def append(self, data: Union[bytes, bytearray, memoryview, str, "IOBuf"]) -> None:
        if isinstance(data, IOBuf):
            # block-level zero-copy: share the BLOCKS, but copy the tiny
            # BlockRef structs.  Refs are mutated in place by cutn/
            # pop_front, so sharing the ref OBJECTS would corrupt every
            # other holder when one of them is cut (iobuf.h:70-97)
            self._refs.extend(BlockRef(r.block, r.offset, r.length)
                              for r in data._refs)
            self._size += data._size
            return
        if isinstance(data, str):
            data = data.encode("utf-8")
        if type(data) is bytes and len(data) >= ZERO_COPY_BYTES_MIN:
            self.append_user_data(data)
            return
        mv = memoryview(data)
        n = len(mv)
        if n == 0:
            return
        pos = 0
        last = self._refs[-1] if self._refs else None
        while pos < n:
            blk = None
            if (last is not None and last.block.kind == HOST
                    and last.offset + last.length == last.block.size
                    and last.block.left_space() > 0):
                blk = last.block
            if blk is None:
                blk = new_host_block(DEFAULT_BLOCK_SIZE)
                last = BlockRef(blk, blk.size, 0)
                self._refs.append(last)
            take = min(n - pos, blk.left_space())
            blk.data[blk.size:blk.size + take] = mv[pos:pos + take]
            blk.size += take
            last.length += take
            pos += take
            self._size += take

    def append_user_data(self, data: Union[memoryview, bytes, bytearray],
                         deleter: Optional[Callable[[Any], None]] = None,
                         meta: int = 0) -> None:
        """Wrap external memory zero-copy (iobuf.h:253
        append_user_data_with_meta)."""
        blk = Block(USER, memoryview(data), meta=meta, deleter=deleter)
        self._refs.append(BlockRef(blk, 0, len(blk.data)))
        self._size += len(blk.data)

    def append_device_array(self, arr, meta: int = 0) -> None:
        """Wrap a flat ``torch.uint8`` tensor owned by a mesh rank —
        zero-copy ref."""
        import torch
        if (not isinstance(arr, torch.Tensor) or arr.dtype != torch.uint8
                or arr.dim() != 1):
            raise TypeError("device block must be a flat uint8 tensor")
        n = arr.shape[0]
        blk = Block(DEVICE, arr, meta=meta, size=n)
        self._refs.append(BlockRef(blk, 0, n))
        self._size += n

    def append_device_array_unchecked(self, arr, nbytes: int) -> None:
        """append_device_array for a tensor already known to be flat
        uint8 of ``nbytes`` (one re-emerging from the native plane's
        registry): no type or shape checks."""
        blk = Block(DEVICE, arr, meta=0, size=nbytes)
        self._refs.append(BlockRef(blk, 0, nbytes))
        self._size += nbytes

    def push_back(self, byte: int) -> None:
        self.append(bytes([byte]))

    # ---- consume -----------------------------------------------------
    def clear(self) -> None:
        self._refs.clear()
        self._size = 0

    def pop_front(self, n: int) -> int:
        n = min(n, self._size)
        left = n
        while left > 0:
            r = self._refs[0]
            if r.length <= left:
                left -= r.length
                self._refs.pop(0)
            else:
                r.offset += left
                r.length -= left
                left = 0
        self._size -= n
        return n

    def pop_back(self, n: int) -> int:
        n = min(n, self._size)
        left = n
        while left > 0:
            r = self._refs[-1]
            if r.length <= left:
                left -= r.length
                self._refs.pop()
            else:
                r.length -= left
                left = 0
        self._size -= n
        return n

    def cutn(self, out: "IOBuf", n: int) -> int:
        """Move first n bytes into out (ref moves, no copies)."""
        n = min(n, self._size)
        left = n
        while left > 0:
            r = self._refs[0]
            if r.length <= left:
                out._refs.append(r)
                out._size += r.length
                left -= r.length
                self._refs.pop(0)
            else:
                out._refs.append(BlockRef(r.block, r.offset, left))
                out._size += left
                r.offset += left
                r.length -= left
                left = 0
        self._size -= n
        return n

    def cut(self, n: int) -> "IOBuf":
        out = IOBuf()
        self.cutn(out, n)
        return out

    def cut_until(self, delim: bytes) -> Optional["IOBuf"]:
        """Cut up to (excluding) delim, also consuming delim; None if
        absent."""
        idx = self.to_bytes().find(delim)
        if idx < 0:
            return None
        out = self.cut(idx)
        self.pop_front(len(delim))
        return out

    # ---- read --------------------------------------------------------
    def to_bytes(self) -> bytes:
        if len(self._refs) == 1:
            r = self._refs[0]
            return bytes(r.block.host_view(r.offset, r.length))
        return b"".join(
            bytes(r.block.host_view(r.offset, r.length)) for r in self._refs)

    def copy_to(self, n: Optional[int] = None, pos: int = 0) -> bytes:
        """``n`` bytes (all with None) from offset ``pos``, not consumed."""
        data = self.to_bytes()
        return data[pos:] if n is None else data[pos:pos + n]

    def fetch(self, n: int) -> Optional[bytes]:
        """Peek first n bytes without consuming; None if fewer available."""
        if self._size < n:
            return None
        out = []
        left = n
        for r in self._refs:
            take = min(left, r.length)
            out.append(bytes(r.block.host_view(r.offset, take)))
            left -= take
            if left == 0:
                break
        return b"".join(out)

    def fetch1(self) -> Optional[int]:
        b = self.fetch(1)
        return b[0] if b else None

    def host_views(self) -> List[memoryview]:
        """Per-ref memoryviews (each DEVICE ref copies to the host)."""
        return [r.block.host_view(r.offset, r.length) for r in self._refs]

    def device_refs(self) -> List[BlockRef]:
        return [r for r in self._refs if r.block.kind == DEVICE]

    def has_device_blocks(self) -> bool:
        return any(r.block.kind == DEVICE for r in self._refs)

    def device_bytes(self) -> int:
        """Bytes referenced from DEVICE blocks: the volume a transport's
        device plane is responsible for moving."""
        return sum(r.length for r in self._refs if r.block.kind == DEVICE)

    # ---- fd IO (reference cut_into_file_descriptor iobuf.h:160) ------
    def cut_into_file_descriptor(self, fd: int,
                                 size_hint: int = 1 << 20) -> int:
        """``writev`` the leading refs into ``fd`` and pop what was
        written.  A DEVICE ref reaches the fd through :meth:`Block.
        host_view`, its one device-to-host copy."""
        views = []
        total = 0
        for r in self._refs:
            if total >= size_hint or len(views) >= 64:    # IOV_MAX safety
                break
            views.append(r.block.host_view(r.offset, r.length))
            total += r.length
        if not views:
            return 0
        written = os.writev(fd, views)
        if written > 0:
            self.pop_front(written)
        return written

    def copy_to_file_descriptor(self, fd: int) -> int:
        """Write every byte into ``fd`` without consuming them."""
        written = 0
        for v in self.host_views():
            written += os.write(fd, v)
        return written


class IOPortal(IOBuf):
    """The read-side buffer a socket's transport fills (reference
    IOPortal); inbox-backed transports cut already-resident refs into it,
    a TCP socket reads into it (:meth:`append_from_socket`)."""

    def append_from_file_descriptor(self, fd: int,
                                    max_count: int = 1 << 16) -> int:
        """``readv`` into a fresh host block: the bytes read, 0 at EOF, -1
        when nothing is ready (EAGAIN)."""
        blk = new_host_block(max(max_count, DEFAULT_BLOCK_SIZE))
        try:
            nr = os.readv(fd, [memoryview(blk.data)[:max_count]])
        except (BlockingIOError, InterruptedError):
            return -1
        if nr > 0:
            blk.size = nr
            self._refs.append(BlockRef(blk, 0, nr))
            self._size += nr
        return nr

    def append_from_socket(self, sock, max_count: int = 1 << 16) -> int:
        """``recv_into`` a fresh host block: the bytes read, 0 at EOF, -1
        when nothing is ready (EAGAIN)."""
        blk = new_host_block(max(max_count, DEFAULT_BLOCK_SIZE))
        try:
            nr = sock.recv_into(memoryview(blk.data)[:max_count], max_count)
        except (BlockingIOError, InterruptedError):
            return -1
        if nr > 0:
            blk.size = nr
            self._refs.append(BlockRef(blk, 0, nr))
            self._size += nr
        return nr


class IOBufCutter:
    """Parsing cursor over an IOBuf (reference IOBufCutter,
    iobuf_inl.h): consumes from the front."""

    __slots__ = ("_buf",)

    def __init__(self, buf: IOBuf):
        self._buf = buf

    def remaining(self) -> int:
        return len(self._buf)

    def cutn_bytes(self, n: int) -> Optional[bytes]:
        if len(self._buf) < n:
            return None
        return self._buf.cut(n).to_bytes()

    def cutn(self, out: IOBuf, n: int) -> int:
        return self._buf.cutn(out, n)

    def _cut_be(self, n: int) -> Optional[int]:
        b = self.cutn_bytes(n)
        return None if b is None else int.from_bytes(b, "big")

    def cut_uint8(self) -> Optional[int]:
        return self._cut_be(1)

    def cut_uint32_be(self) -> Optional[int]:
        return self._cut_be(4)

    def cut_uint64_be(self) -> Optional[int]:
        return self._cut_be(8)


class IOBufAppender:
    """Sequential writer producing an IOBuf (reference IOBufAppender)."""

    def __init__(self):
        self.buf = IOBuf()

    def append(self, data) -> None:
        self.buf.append(data)

    def append_uint32_be(self, v: int) -> None:
        self.buf.append(v.to_bytes(4, "big"))

    def append_uint64_be(self, v: int) -> None:
        self.buf.append(v.to_bytes(8, "big"))

    def move_to(self) -> IOBuf:
        out = self.buf
        self.buf = IOBuf()
        return out
