"""Combo channels (reference: the combo channels of
src/brpc/parallel_channel.h, partition_channel.h and selective_channel.h):
the host-side ParallelChannel, PartitionChannel, DynamicPartitionChannel
and SelectiveChannel, whose sub-calls take the RPC loop (a DEVICE
attachment crosses an ``ici://`` member on the device plane); the compiled
fan-out route those channels try first for an operand call
(``collective_fanout``: ``Server.register_collective`` bodies, run and
merged on the mesh, degrading in-call to the RPC loop); and
CollectiveChannel, the same fan-out semantics lowered to mesh collectives
with no RPC at all."""
from .parallel_channel import (ParallelChannel, CallMapper, ResponseMerger,
                               SubCall)
from .partition_channel import (PartitionChannel, DynamicPartitionChannel,
                                PartitionParser)
from .selective_channel import SelectiveChannel
from .collective_lowering import (CollectiveChannel, MERGE_SUM, MERGE_GATHER,
                                  MERGE_CONCAT, MERGE_NONE, MAP_REPLICATE,
                                  MAP_SHARD)
from .collective_fanout import (CollectiveFanoutPlane, CollectiveMerger,
                                ShardingCallMapper, ReplicateFanoutMapper,
                                FanoutRows, register_device_handler,
                                shard_operand)
