"""``tests/test_ring_attention.py`` on both packages
(``tests/torch_mirror.py``): ring attention and Ulysses attention against
the dense reference, causal and not, on 8 ranks.  The port's copy runs on
CPU ranks; its inputs are the JAX copy's ``jax.random`` draws, handed to
the port as CPU tensors, so both copies run on identical values (the
swaps are listed in ``tests/torch_array_swaps.py``, ``RING_ATTENTION``).

Left out of the port's copy: ``TestRingAttention::test_compile_cached``,
which reads ``ring_attention._cache``, the JAX jit cache of the compiled
attention programs.  The port runs its attention eagerly per rank and
compiles nothing; ``tests/test_torch_ring_attention.py`` holds the
port's results against the JAX package's on the same inputs.
"""
from __future__ import annotations

from tests import torch_array_swaps
from tests import torch_mirror

torch_mirror.mirror("tests/test_ring_attention.py", globals(),
                    swaps=torch_array_swaps.RING_ATTENTION, cpu_mesh=True)

# the JAX jit cache (above)
TestRingAttentionPort.test_compile_cached = None  # noqa: F821
