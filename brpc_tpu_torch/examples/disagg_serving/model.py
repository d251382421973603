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


# sin's argument reduction (fdlibm's ``pio2_1``/``pio2_1t``: the first 33
# bits of pi/2, so n * _PIO2_HI is exact for |n| < 2**20, and the rest)
# and its kernels' minimax coefficients on [-pi/4, pi/4]
_TWO_OVER_PI = 6.36619772367581382433e-01
_PIO2_HI = 1.57079632673412561417e+00
_PIO2_LO = 6.07710050650619224932e-11
_SIN_C = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
          -1.98412698298579493134e-04, 2.75573137070700676789e-06,
          -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_COS_C = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
          2.48015872894767294178e-05, -2.75573143513906633035e-07,
          2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _horner(z: torch.Tensor, coeffs) -> torch.Tensor:
    acc = torch.full_like(z, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = acc * z + c
    return acc


def sin_f32(x: torch.Tensor) -> torch.Tensor:
    """``sin`` of a float32 tensor, rounded from a float64 evaluation made
    of elementwise IEEE adds and multiplies only: the same bits on the CPU
    at any intra-op thread count and on the card.  ``torch.sin`` on the
    CPU runs MKL's vector sin chunk by chunk on the OpenMP pool, and under
    load some pool threads' chunks came back up to ~1e-4 off, which moved
    KV bytes (``tests/test_torch_serving_determinism.py``)."""
    xd = x.double()
    n = torch.round(xd * _TWO_OVER_PI)
    r = (xd - n * _PIO2_HI) - n * _PIO2_LO               # |r| <= pi/4
    z = r * r
    s = r + r * z * _horner(z, _SIN_C)
    c = (1.0 - z * 0.5) + z * z * _horner(z, _COS_C)
    q = torch.remainder(n.to(torch.int64), 4)
    out = torch.where((q & 1) == 1, c, s)
    out = torch.where(q >= 2, -out, out)
    return out.float()


def toy_kv_blocks(tokens: List[int], device=None) -> torch.Tensor:
    """Prefill: prompt token ids -> quantized KV-cache bytes, one flat
    uint8 tensor of ``KV_LAYERS * len(tokens) * KV_DMODEL`` bytes on
    ``device``, layer-major.  Deterministic in the token ids: the same
    bytes at every intra-op thread count and on every device (``sin``
    is :func:`sin_f32`; the running sum is a per-column serial scan on
    the CPU)."""
    dev = _device(device)
    t = torch.tensor(tokens, dtype=torch.float32, device=dev)      # (seq,)
    cols = torch.arange(KV_DMODEL, dtype=torch.float32,
                        device=dev) / KV_DMODEL
    base = torch.outer(t + 1.0, cols)                              # (seq, d)
    run = torch.cumsum(base, dim=0) * 1e-3
    kv = torch.stack([sin_f32(base * (layer + 1)) + run
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
