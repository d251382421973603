"""``tests/test_auth_naming_extras.py``'s ``TestRegistryNaming`` and
``TestCompack`` on both packages (``tests/torch_mirror.py``): the
HTTP-registry naming services against an in-process registry and the
compack serialization.  The file's other three classes
(``TestRedisAuth``, ``TestCouchbaseAuth``, ``TestTrackme``) are mirrored
by ``tests/test_torch_auth.py``.

The one swap, as in ``tests/test_torch_auth.py``: the port's copy takes
``KvRedis``, ``start_mini_memcached`` and ``unique`` from the port's copy
of ``tests/test_redis_memcache.py`` (``torch_mirror.load``), where the
JAX file imports the JAX module's.

No case is left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror(
    "tests/test_auth_naming_extras.py", globals(),
    names=["TestRegistryNaming", "TestCompack"],
    swaps=[("from tests.test_redis_memcache import (KvRedis, "
            "start_mini_memcached,\n                                       "
            "unique)",
            "from tests.torch_mirror import load as _load\n"
            "_rm = _load('tests/test_redis_memcache.py', True)\n"
            "KvRedis, start_mini_memcached, unique = (\n"
            "    _rm.KvRedis, _rm.start_mini_memcached, _rm.unique)")])
