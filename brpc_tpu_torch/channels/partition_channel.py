"""PartitionChannel / DynamicPartitionChannel.

Reference: src/brpc/partition_channel.{h,cpp}, ported from
:mod:`brpc_tpu.channels.partition_channel`.  Servers announce partition
membership through naming-service tags "i/M" (PartitionParser::ParseFromTag,
partition_channel.h:46-52); a PartitionChannel builds one sub-channel per
partition (each LB-balanced over that partition's replicas) and fans every
call out across partitions like a ParallelChannel.  The Dynamic variant
watches several partition schemes (different M) at once and weights traffic
by each scheme's serving capacity.

Each partition's sub-channel is a Channel whose balancer is that
partition's, so a call to it takes the whole client stack (request
context, breaker, an ``ici://`` member's DEVICE attachment on the device
plane).
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..rpc import errors
from ..rpc.channel import Channel, ChannelOptions
from ..rpc.controller import Controller
from ..policy.load_balancers import ServerEntry, create_load_balancer
from ..policy.naming import get_naming_service_thread
from .parallel_channel import ParallelChannel, CallMapper, ResponseMerger

_PARTITION_RE = re.compile(r"^(\d+)/(\d+)$")


class PartitionParser:
    """tag → (index, count) or None (partition_channel.h:46-52)."""

    def parse_from_tag(self, tag: str) -> Optional[Tuple[int, int]]:
        m = _PARTITION_RE.match(tag.strip())
        if not m:
            return None
        idx, cnt = int(m.group(1)), int(m.group(2))
        if cnt <= 0 or idx >= cnt:
            return None
        return idx, cnt


class _PartitionLB:
    """Watcher splitting a naming service's entries into per-partition LBs."""

    def __init__(self, num_partitions: int, parser: PartitionParser,
                 lb_name: str):
        self.num_partitions = num_partitions
        self.parser = parser
        self.lbs = [create_load_balancer(lb_name)
                    for _ in range(num_partitions)]
        self.scheme_capacity = 0        # servers matching this scheme

    def reset_servers(self, entries: List[ServerEntry]) -> None:
        buckets: List[List[ServerEntry]] = [[] for _ in range(self.num_partitions)]
        cap = 0
        for e in entries:
            parsed = self.parser.parse_from_tag(e.tag)
            if parsed is None:
                continue
            idx, cnt = parsed
            if cnt != self.num_partitions:
                continue
            buckets[idx].append(e)
            cap += 1
        for lb, bucket in zip(self.lbs, buckets):
            lb.reset_servers(bucket)
        self.scheme_capacity = cap

    def complete(self) -> bool:
        return all(lb.server_count() > 0 for lb in self.lbs)


class _SubChannelOverLB(Channel):
    """Channel whose server selection delegates to a shared per-partition
    LB (so PartitionChannel reuses the whole client stack)."""

    def __init__(self, lb, options: Optional[ChannelOptions] = None):
        super().__init__()
        if options is not None:
            self.options = options
        from ..rpc.protocol import find_protocol
        self._protocol = find_protocol("tpu_std")
        self._lb = lb


class PartitionChannel(ParallelChannel):
    def __init__(self, fail_limit: int = -1):
        super().__init__(fail_limit)
        self._ns_thread = None
        self._plb: Optional[_PartitionLB] = None

    def init(self, num_partitions: int, naming_url: str, lb_name: str = "rr",
             options: Optional[ChannelOptions] = None,
             parser: Optional[PartitionParser] = None,
             mapper: Optional[CallMapper] = None,
             merger: Optional[ResponseMerger] = None) -> int:
        self._plb = _PartitionLB(num_partitions, parser or PartitionParser(),
                                 lb_name)
        self._ns_thread = get_naming_service_thread(naming_url)
        self._ns_thread.add_watcher(self._plb)
        for i in range(num_partitions):
            sub = _SubChannelOverLB(self._plb.lbs[i], options)
            self.add_channel(sub, mapper, merger)
        return 0

    @property
    def num_partitions(self) -> int:
        return self._plb.num_partitions if self._plb else 0

    def partitions_ready(self) -> bool:
        return self._plb is not None and self._plb.complete()

    def close(self) -> None:
        """Stop watching the naming service and close every partition's
        connections."""
        if self._ns_thread is not None and self._plb is not None:
            self._ns_thread.remove_watcher(self._plb)
        for chan, _, _ in self._subs:
            chan.close()


class DynamicPartitionChannel:
    """Traffic migrates across partition schemes by capacity
    (partition_channel.cpp Dynamic*)."""

    def __init__(self, fail_limit: int = -1):
        self.fail_limit = fail_limit
        self._schemes: Dict[int, PartitionChannel] = {}
        self._naming_url = ""
        self._lb_name = "rr"
        self._options: Optional[ChannelOptions] = None
        self._parser = PartitionParser()
        self._mapper: Optional[CallMapper] = None
        self._merger: Optional[ResponseMerger] = None

    def init(self, partition_counts: List[int], naming_url: str,
             lb_name: str = "rr", options: Optional[ChannelOptions] = None,
             mapper: Optional[CallMapper] = None,
             merger: Optional[ResponseMerger] = None) -> int:
        self._naming_url = naming_url
        self._lb_name = lb_name
        self._options = options
        self._mapper = mapper
        self._merger = merger
        for m in partition_counts:
            pc = PartitionChannel(self.fail_limit)
            pc.init(m, naming_url, lb_name, options, self._parser,
                    mapper, merger)
            self._schemes[m] = pc
        return 0

    def close(self) -> None:
        for pc in self._schemes.values():
            pc.close()

    def _pick_scheme(self) -> Optional[PartitionChannel]:
        from ..butil.misc import fast_rand_less_than
        ready = [(pc._plb.scheme_capacity, pc)
                 for pc in self._schemes.values() if pc.partitions_ready()]
        if not ready:
            return None
        total = sum(cap for cap, _ in ready)
        if total <= 0:
            return ready[0][1]
        r = fast_rand_less_than(total)
        acc = 0
        for cap, pc in ready:
            acc += cap
            if r < acc:
                return pc
        return ready[-1][1]

    def call_method(self, method_full_name: str, cntl: Controller,
                    request: Any, response: Any = None,
                    done: Optional[Callable] = None):
        pc = self._pick_scheme()
        if pc is None:
            cntl.set_failed(errors.ENODATA, "no complete partition scheme")
            if done: done(cntl)
            return None
        return pc.call_method(method_full_name, cntl, request, response, done)
