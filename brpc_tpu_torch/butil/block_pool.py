"""Device block pool: pre-committed device blocks behind IOBuf.

Port of :mod:`brpc_tpu.butil.block_pool` (reference
src/brpc/rdma/block_pool.{h,cpp}, InitBlockPool/AllocBlock at
block_pool.h:76-88: the RDMA transport takes IOBuf allocation over with a
pool of registered regions so sends and receives are zero-copy).

Here "registered memory" is device memory held by live flat ``uint8``
tensors.  The caching allocator owns physical allocation, so the pool
manages *budget and reuse* rather than raw pointers: it pre-commits a fixed
number of blocks, hands them out for transport staging, and takes them back
(optionally replaced by a result tensor that now owns the memory).
Exhaustion behaves like the reference: ``alloc`` returns None, the caller
falls back to a plain allocation and ``nonpooled_allocs`` ticks.  A pool
lives on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

DEFAULT_BLOCK_SIZE = 64 * 1024


class PooledBlock:
    __slots__ = ("pool", "bid", "array")

    def __init__(self, pool: "BlockPool", bid: int, array):
        self.pool = pool
        self.bid = bid
        self.array = array      # flat uint8 tensor

    def __len__(self) -> int:
        return self.array.shape[0]

    def release(self, replacement=None) -> None:
        self.pool.free(self, replacement)


class BlockPool:
    def __init__(self, block_size: int = DEFAULT_BLOCK_SIZE,
                 capacity: int = 32, device=None):
        import torch
        self.block_size = block_size
        self.capacity = capacity
        self.device = torch.device(device if device is not None else "cuda")
        self._lock = threading.Lock()
        self._free: List[PooledBlock] = []
        self._outstanding = 0
        self.nonpooled_allocs = 0       # pool-exhausted fallbacks
        for i in range(capacity):
            arr = torch.zeros(block_size, dtype=torch.uint8,
                              device=self.device)
            self._free.append(PooledBlock(self, i, arr))

    def alloc(self) -> Optional[PooledBlock]:
        with self._lock:
            if not self._free:
                self.nonpooled_allocs += 1
                return None
            blk = self._free.pop()
            self._outstanding += 1
            return blk

    def free(self, blk: PooledBlock, replacement=None) -> None:
        if replacement is not None:
            if replacement.numel() != self.block_size:
                raise ValueError("replacement array size mismatch")
            blk.array = replacement
        with self._lock:
            self._free.append(blk)
            self._outstanding -= 1

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def total_bytes(self) -> int:
        return self.block_size * self.capacity


_global_pools: Dict[str, BlockPool] = {}
_global_lock = threading.Lock()


def init_block_pool(name: str = "default",
                    block_size: int = DEFAULT_BLOCK_SIZE,
                    capacity: int = 32, device=None) -> BlockPool:
    """Reference InitBlockPool: one-time pool creation keyed by name."""
    with _global_lock:
        if name not in _global_pools:
            _global_pools[name] = BlockPool(block_size, capacity, device)
        return _global_pools[name]


def get_block_pool(name: str = "default") -> Optional[BlockPool]:
    with _global_lock:
        return _global_pools.get(name)
