"""Disaggregated prefill/decode serving on the port: prefill workers turn
prompts into KV-cache bytes, decode workers stream tokens out of them,
and the KV moves between them as a DEVICE payload over the device plane.
Counterpart of ``examples/disagg_serving``."""
from .model import (KV_DMODEL, KV_LAYERS, reference_generate, toy_decode,
                    toy_kv_blocks)
from .workers import (DecodeService, PrefillService, RouterService,
                      close_services, start_decode_worker,
                      start_prefill_worker, start_router)
