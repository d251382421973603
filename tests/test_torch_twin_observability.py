"""``tests/test_observability.py``'s in-process classes on both packages
(``tests/torch_mirror.py``): the span units (wall anchors, the clock
table, the stitched tree), the client span's device-plane annotations,
the tpu_std stage decomposition, and the builtin RPC services
(``brpc_tpu.Trace`` and ``brpc_tpu.Builtin``, service names the two
packages share on the wire).  The port's copy runs on a CPU default mesh
of 8 ranks (``cpu_mesh=True``); the swaps are listed in
``tests/torch_array_swaps.py`` (``OBSERVABILITY``).

Repaired in the port by this suite: the builtin RPC services refuse with
EPERM on a server whose ``ServerOptions.internal_port`` moved the admin
pages off its public port (``TestBuiltinRpc::
test_builtin_call_refused_when_admin_moved_to_internal_port``; the port
served the span store and every page there).

JAX-only, both copies left out (they run in
``tests/test_observability.py`` itself): the module-level
``test_cross_process_trace_continuity_and_clock_bound`` and
``test_disagg_pod_trace_is_complete_from_one_query_n3`` start two and
three JAX child processes (``tests/test_pod.py``'s ``_run_pod``).  The
port's own are ``tests/test_torch_pod_scope.py::
test_cross_process_trace_continuity_and_clock_bound`` and
``tests/test_torch_pod.py::test_three_process_pod_generate_trace_and_drain``.
"""
from __future__ import annotations

from tests import torch_array_swaps
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_observability.py", globals(),
                    swaps=torch_array_swaps.OBSERVABILITY, cpu_mesh=True)

# JAX child processes (above)
del test_cross_process_trace_continuity_and_clock_bound_jax  # noqa: F821
del test_cross_process_trace_continuity_and_clock_bound_port  # noqa: F821
del test_disagg_pod_trace_is_complete_from_one_query_n3_jax  # noqa: F821
del test_disagg_pod_trace_is_complete_from_one_query_n3_port  # noqa: F821
