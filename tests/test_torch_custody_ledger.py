"""The runtime custody ledger on both packages: every test of
``tests/test_custody_ledger.py`` over ``brpc_tpu`` and over
``brpc_tpu_torch`` (``tests/torch_mirror.py``), under the port's census.

Swaps in the port's copy:
- the pool helpers: the JAX file takes ``_mk_pool`` and ``_rows`` from
  ``tests/test_serving.py`` (the JAX pool, the JAX toy model's KV bytes);
  the port's copy builds the port's ``PagedKvPool`` on the CPU and the
  rows from the port's toy model
  (``brpc_tpu_torch/examples/disagg_serving/model.py``), token-major as
  the JAX helper makes them;
- ``TestEchoBenchRegression``: the borrowed device array is a CPU
  ``torch.uint8`` tensor (``import jax.numpy as jnp`` ->
  ``import torch as jnp``; ``zeros``/``uint8`` have the same spelling).

Both copies run under ``BRPC_TPU_DEBUG_CUSTODY=1`` (``tests/conftest.py``
sets it before any import), and the module takes the port's custody
census (``tests/torch_census.py``) besides the root census of the JAX
ledger.  No case is left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_census import custody_census  # noqa: F401  (fixture)

_PORT_POOL = '''import torch as _torch
from brpc_tpu_torch.examples.disagg_serving import model as _tmodel


def _rows(tokens):
    """Prompt -> token-major pool rows (the LoadKv transpose)."""
    seq = len(tokens)
    kv = _tmodel.toy_kv_blocks(tokens, "cpu")
    return kv.reshape(_tmodel.KV_LAYERS, seq, _tmodel.KV_DMODEL).permute(
        1, 0, 2).reshape(seq, _tmodel.KV_LAYERS * _tmodel.KV_DMODEL)


def _mk_pool(num_blocks=32, block_tokens=8, ttl_s=120.0,
             use_timers=False, now=None, **kw):
    from brpc_tpu_torch.serving import KvPoolOptions, PagedKvPool
    opts = KvPoolOptions(
        bytes_per_token=_tmodel.KV_LAYERS * _tmodel.KV_DMODEL,
        num_blocks=num_blocks, block_tokens=block_tokens, ttl_s=ttl_s,
        use_timers=use_timers, **kw)
    return PagedKvPool(opts, device="cpu", now=now)'''

torch_mirror.mirror("tests/test_custody_ledger.py", globals(), swaps=[
    ("from test_serving import _mk_pool, _rows", _PORT_POOL),
    ("import jax.numpy as jnp", "import torch as jnp"),
])
