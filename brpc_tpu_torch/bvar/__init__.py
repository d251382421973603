"""bvar — the metrics layer (reference: src/bvar/), ported from
:mod:`brpc_tpu.bvar`: named variables in one expose registry (read by the
/vars and /brpc_metrics builtin pages), write-local reducers, windows
ticked by one sampler thread, latency recorders with percentile
reservoirs, labelled families, the sampling collector and the process's
default variables."""
from .variable import (Variable, Status, PassiveStatus, GFlag, find_exposed,
                       list_exposed, dump_exposed, count_exposed,
                       to_underscored_name)
from .reducer import Reducer, Adder, Maxer, Miner
from .window import Window, PerSecond, SamplerCollector
from .latency_recorder import IntRecorder, Percentile, LatencyRecorder
from .multi_dimension import MultiDimension
from .default_variables import expose_default_variables
from .collector import Collector, CollectorSpeedLimit, Collected
