"""The butil layer on both packages: every test of ``tests/test_butil.py``
over ``brpc_tpu`` and over ``brpc_tpu_torch`` (``tests/torch_mirror.py``).

Swaps in the port's copy:
- ``test_device_block`` wraps a flat ``torch.uint8`` tensor on the CPU
  where the JAX file wraps a ``jnp`` array (``import jax.numpy as jnp`` ->
  ``import torch as jnp``: ``arange``/``uint8`` have the same spelling), as
  the port's DEVICE blocks hold tensors.

No case is left out.  ``test_fast_rand`` draws from each package's own
generator and checks only distinctness and range, so it needs no swap.
"""
from __future__ import annotations

from tests import torch_mirror

torch_mirror.mirror("tests/test_butil.py", globals(), swaps=[
    ("import jax.numpy as jnp", "import torch as jnp"),
])


def test_block_pool_defaults_to_the_card_and_counts_like_jax():
    """The port's BlockPool holds flat uint8 tensors on the card unless
    the caller asks for the CPU; alloc, exhaustion and a replacement
    behave as the JAX pool's do."""
    import pytest
    import torch
    from brpc_tpu_torch.butil import block_pool
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            block_pool.BlockPool(block_size=16, capacity=1)
    pool = block_pool.BlockPool(block_size=16, capacity=2, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    assert len(a) == 16 and a.array.dtype == torch.uint8
    assert pool.alloc() is None and pool.nonpooled_allocs == 1
    assert pool.outstanding() == 2 and pool.free_count() == 0
    a.release(torch.ones(16, dtype=torch.uint8))
    with pytest.raises(ValueError):
        b.release(torch.ones(8, dtype=torch.uint8))
    assert pool.free_count() == 1 and pool.total_bytes() == 32
    assert bool(pool.alloc().array.eq(1).all())
