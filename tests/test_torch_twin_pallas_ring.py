"""``tests/test_pallas_ring.py`` on both packages
(``tests/torch_mirror.py``): the ring all-gather and all-reduce kernels
through their entry points, ``pallas_ring.ring_all_gather`` and
``ring_all_reduce``.  The JAX copy runs the Pallas kernels in interpret
mode; the port's copy runs on 8 CPU ranks, where the wrappers take their
plain versions (``ring_all_gather_plain``, ``ring_all_reduce_plain``),
since the rows lie on the CPU.  The swaps are listed in
``tests/torch_array_swaps.py`` (``PALLAS_RING``).

Left out of the port's copy: ``TestPallasRing::test_kernel_cache``, which
reads ``pallas_ring._cache``, the JAX jit cache of the built Pallas
programs.  The port's kernels are built once per process from their CUDA
sources and take every shape, so nothing is cached per shape;
``tests/test_torch_pallas_ring.py::
test_build_targets_hopper_from_the_package_sources`` holds the build and
``test_cpu_rows_take_the_plain_versions_without_a_launch`` the plain
route.
"""
from __future__ import annotations

from tests import torch_array_swaps
from tests import torch_mirror

torch_mirror.mirror("tests/test_pallas_ring.py", globals(),
                    swaps=torch_array_swaps.PALLAS_RING, cpu_mesh=True)

# the JAX jit cache (above)
TestPallasRingPort.test_kernel_cache = None  # noqa: F821
