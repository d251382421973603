"""Combo channels lowered to mesh collectives (reference: the combo
channels of src/brpc/parallel_channel.h).  Only the collective lowering is
ported so far; the host-side ParallelChannel and the compiled fan-out wait
for the multi-process slice."""
from .collective_lowering import (CollectiveChannel, MERGE_SUM, MERGE_GATHER,
                                  MERGE_CONCAT, MERGE_NONE, MAP_REPLICATE,
                                  MAP_SHARD)
