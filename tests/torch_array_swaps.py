"""The port copy's swaps for the JAX array calls of the main path's
suites (``tests/test_ici.py``, ``tests/test_device_plane.py``,
``tests/test_pallas_ring.py``, ``tests/test_ring_attention.py``,
``tests/test_collective_fanout.py``, ``tests/test_disagg_serving.py``,
``tests/test_observability.py`` and ``tests/test_server_lifecycle.py``),
shared by their twins ``tests/test_torch_twin_<stem>.py``.

Each swap is a string pair that ``torch_mirror.load`` must find in the
JAX file.  What the port spells differently, and why:

- ``ici.IciMesh(jax.devices())``, the JAX CPU platform's 8 devices, is
  ``ici.IciMesh(ranks=8, device="cpu")``: the port's mesh is of logical
  ranks, and a mesh on the CPU is asked for by name (``IciMesh()`` asks
  for CUDA);
- ``jax.device_put(x, mesh.device(k))`` is ``mesh.device_put(x, k)``: in
  the port a device names no rank (every rank of a CPU mesh, or of a
  one-card mesh, shares the device), so a tensor's rank is recorded by
  the mesh; ``jax.devices()[k]`` is rank k (``rank=k``), and
  ``jax.block_until_ready`` has nothing to wait for after a copy on the
  CPU;
- a test's mesh fixture that makes a mesh and sets it as the default is
  the default mesh itself, taken for each test: the port records a
  tensor's rank on the mesh object that placed it, and the port's copy
  runs each test on a fresh CPU default mesh (``cpu_mesh=True``), which
  is the mesh the transports address;
- the JAX-only flag ``ici_device_plane_kernel`` (it picks one of the
  JAX plane's two transfer programs; the port has one kernel,
  ``p2p_copy``, and the flag is on the census's allowlist) is not saved
  and restored by the plane fixture;
- ``jax.numpy`` is :data:`jnp` below, the same constructors over torch
  on the CPU (a positional dtype, as ``jnp.ones(shape, jnp.float32)``
  takes it; ``arange`` wraps into a narrow dtype as JAX's does);
- ``np.asarray(x)`` is :func:`asarray`: a ``ShardedTensor``, the port's
  layout of a value sharded one row per rank, becomes its rows stacked,
  and a tensor its values;
- a DEVICE block's residency, ``{str(d) for d in arr.devices()}``
  against ``{str(mesh.device(k))}``, is the owning rank,
  ``{mesh.rank_of(arr)}`` against ``{k}``; a result's layout,
  ``len(out.sharding.device_set) == mesh.size``, is the ranks owning its
  rows;
- ``jax.random`` draws (``tests/test_ring_attention.py``) are made with
  JAX in the test as the JAX copy makes them, and the port's copy gets
  them as CPU tensors of the same values: both copies run on identical
  inputs, and the port's copy compares the port's kernels with the
  port's dense reference, as the JAX copy does with the JAX package's.

The per-file lists are below; each twin's docstring names the cases it
leaves out and why.
"""
from __future__ import annotations

import types

import numpy as np
import torch


def asarray(x, dtype=None):
    """``np.asarray`` over the port's values: a ``ShardedTensor``'s rows
    stacked, a tensor's values, anything else as numpy takes it."""
    from brpc_tpu_torch.ici.mesh import ShardedTensor
    if isinstance(x, ShardedTensor):
        x = x.stack()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _arange(n, dtype=None):
    out = torch.arange(n)
    return out if dtype is None else out.to(dtype)


jnp = types.SimpleNamespace(
    uint8=torch.uint8, int32=torch.int32, float32=torch.float32,
    arange=_arange,
    full=lambda shape, value, dtype=None: torch.full(shape, value,
                                                     dtype=dtype),
    ones=lambda shape, dtype=None: torch.ones(shape, dtype=dtype),
    zeros=lambda shape, dtype=None: torch.zeros(shape, dtype=dtype),
    stack=lambda xs: torch.stack(list(xs)),
)

_ARRAYS = [
    ("import numpy as np\n",
     "import numpy as np\nfrom tests.torch_array_swaps import asarray, jnp\n"),
    ("np.asarray(", "asarray("),
]
_JNP = [("import jax.numpy as jnp", "from tests.torch_array_swaps import jnp")]
_MESH = [("ici.IciMesh(jax.devices())", 'ici.IciMesh(ranks=8, device="cpu")')]

ICI = _ARRAYS + _JNP + [
    ('@pytest.fixture(scope="module")\ndef mesh():\n    import jax\n'
     '    m = ici.IciMesh(jax.devices())\n    ici.IciMesh.set_default(m)\n'
     '    return m',
     '@pytest.fixture()\ndef mesh():\n    return ici.IciMesh.default()'),
    ('seen["devices"] = {str(d) for d in refs[0].block.data.devices()}',
     'seen["devices"] = {mesh.rank_of(refs[0].block.data)}'),
    ('assert seen["devices"] == {str(mesh.device(1))}',
     'assert seen["devices"] == {1}'),
    ("payload = jax.device_put(payload, mesh.device(2))",
     "payload = mesh.device_put(payload, 2)"),
    ("arr = jax.device_put(jnp.arange(1024, dtype=jnp.uint8),\n"
     "                             mesh.device(0))\n"
     "        jax.block_until_ready(arr)",
     "arr = mesh.device_put(jnp.arange(1024, dtype=jnp.uint8), 0)"),
]

DEVICE_PLANE = _ARRAYS + [
    ('"ici_device_plane_threshold", "ici_device_plane_kernel",',
     '"ici_device_plane_threshold",'),
    ("    import jax\n    import jax.numpy as jnp\n"
     "    arr = jax.device_put(jnp.arange(nbytes, dtype=jnp.uint8) % mod,\n"
     "                         IciMesh.default().device(dev))\n"
     "    jax.block_until_ready(arr)\n",
     "    arr = IciMesh.default().device_put(\n"
     "        jnp.arange(nbytes, dtype=jnp.uint8) % mod, dev)\n"),
]

PALLAS_RING = _ARRAYS + _JNP + _MESH

_PORT_QKV = '''    import jax, jax.numpy as jnp
    from brpc_tpu.ici.collective import Collectives
    n = mesh.size
    key = jax.random.PRNGKey(seed)
    kq, kk, kv = jax.random.split(key, 3)
    S = n * block
    q, k, v = (torch.from_numpy(np.array(jax.random.normal(
        kx, (S, heads, dim), jnp.float32))) for kx in (kq, kk, kv))
'''

RING_ATTENTION = _ARRAYS + [
    ("    return ici.IciMesh(jax.devices())",
     '    return ici.IciMesh(ranks=8, device="cpu")'),
    ("import numpy as np\n", "import numpy as np\nimport torch\n"),
    ('''    import jax, jax.numpy as jnp
    from brpc_tpu.ici.collective import Collectives
    n = mesh.size
    key = jax.random.PRNGKey(seed)
    kq, kk, kv = jax.random.split(key, 3)
    S = n * block
    q = jax.random.normal(kq, (S, heads, dim), jnp.float32)
    k = jax.random.normal(kk, (S, heads, dim), jnp.float32)
    v = jax.random.normal(kv, (S, heads, dim), jnp.float32)
''', _PORT_QKV),
    ("assert len(out.sharding.device_set) == mesh.size",
     "assert len({mesh.rank_of(r) for r in out.rows}) == mesh.size"),
]

COLLECTIVE_FANOUT = _ARRAYS

# the disaggregated example's import paths as in
# ``tests/torch_serving_swaps.py``; a worker the JAX test starts on
# ``jax.devices()[k]`` starts on rank k, and the single-process reference
# runs on the CPU, where the JAX one relies on JAX's CPU default
DISAGG_SERVING = [
    ("from examples.example_echo_pb2", "from brpc_tpu.proto.echo_pb2"),
    ("from examples.disagg_serving", "from brpc_tpu.examples.disagg_serving"),
    ("device=devs[4]", "rank=4"),
    ("device=devs[5]", "rank=5"),
    ("reference_generate(tokens, 12)",
     'reference_generate(tokens, 12, device="cpu")'),
    ("reference_generate(tokens, 6)",
     'reference_generate(tokens, 6, device="cpu")'),
]

OBSERVABILITY = _JNP + [
    ("payload = jax.device_put(jnp.arange(65536, dtype=jnp.uint8),\n"
     "                                     mesh.device(1))\n"
     "            jax.block_until_ready(payload)",
     "payload = mesh.device_put(jnp.arange(65536, dtype=jnp.uint8), 1)"),
]

SERVER_LIFECYCLE = _JNP + [
    ("        mesh = ici.IciMesh()\n",
     '        mesh = ici.IciMesh(ranks=8, device="cpu")\n'),
    ("arr = jax.device_put(jnp.zeros(65536, jnp.uint8), mesh.device(0))\n"
     "        jax.block_until_ready(arr)",
     "arr = mesh.device_put(jnp.zeros(65536, jnp.uint8), 0)"),
]
