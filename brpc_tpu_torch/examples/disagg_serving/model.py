"""The toy model behind the disaggregated-serving example, in PyTorch.

Counterpart of ``examples/disagg_serving/model.py``, shaped like the real
thing:

  * **prefill** is compute-shaped: a whole prompt becomes a KV cache in
    one pass — a deterministic transform of the token ids into a
    ``(layers, seq, d_model)`` tensor, QUANTIZED to uint8 (a flat uint8
    device tensor is what the device plane moves);
  * **decode** is memory-shaped: each step reads the whole cache and
    emits one token — a deterministic integer recurrence over the cache
    statistics, a function of every cache byte, so a corrupted handoff
    changes the output.

Entry points put their tensors on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import List

import torch

KV_LAYERS = 4
KV_DMODEL = 256
VOCAB = 50257


def _device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the toy model on the host")
    return dev


def toy_kv_blocks(tokens: List[int], device=None) -> torch.Tensor:
    """Prefill: prompt token ids -> quantized KV-cache bytes, one flat
    uint8 tensor of ``KV_LAYERS * len(tokens) * KV_DMODEL`` bytes on
    ``device``, layer-major.  Deterministic in the token ids."""
    dev = _device(device)
    t = torch.tensor(tokens, dtype=torch.float32, device=dev)      # (seq,)
    cols = torch.arange(KV_DMODEL, dtype=torch.float32,
                        device=dev) / KV_DMODEL
    base = torch.outer(t + 1.0, cols)                              # (seq, d)
    run = torch.cumsum(base, dim=0) * 1e-3
    kv = torch.stack([torch.sin(base * (layer + 1)) + run
                      for layer in range(KV_LAYERS)])            # (L, seq, d)
    kv_q = (torch.clamp(kv, -4.0, 4.0) * 16.0 + 128.0).to(torch.uint8)
    return kv_q.reshape(-1)


def kv_nbytes(seq_len: int) -> int:
    return KV_LAYERS * seq_len * KV_DMODEL


def toy_decode(kv_u8, seq_len: int, last_token: int,
               steps: int) -> List[int]:
    """Decode: stream ``steps`` tokens out of the quantized cache (a flat
    layer-major uint8 tensor or array).  Each step folds the per-position
    cache sums (the "attention read") into an integer recurrence.  The
    sums are one reduction on the cache's device and one copy to the
    host."""
    kv = torch.as_tensor(kv_u8).reshape(KV_LAYERS, seq_len, KV_DMODEL)
    pos_sums = kv.sum(dim=(0, 2), dtype=torch.int64).tolist()      # (seq,)
    acc = sum(pos_sums)
    toks: List[int] = []
    prev = last_token
    for i in range(steps):
        read = pos_sums[(prev + i) % seq_len]
        prev = (acc + read * (i + 1) + prev * 31) % VOCAB
        toks.append(prev)
    return toks


def reference_generate(tokens: List[int], steps: int,
                       device=None) -> List[int]:
    """Single-process reference: what the disaggregated pipeline must
    reproduce exactly."""
    kv = toy_kv_blocks(tokens, device)
    return toy_decode(kv, len(tokens), tokens[-1], steps)
