"""Run a JAX package test file over both packages.

``mirror(path, namespace)`` loads the test file twice: as it is, and with
every ``brpc_tpu`` module it imports swapped for its ``brpc_tpu_torch``
counterpart (plus the file's own ``swaps``, for what lives elsewhere in
the port).  Each test class and module-level test of the two copies lands
in ``namespace`` under the package's name, ``TestFooJax`` / ``TestFooPort``
and ``test_foo_jax`` / ``test_foo_port``, so pytest collects every test of
the file once per package with its fixtures intact.  The file on disk is
read, never edited.

A copy runs in the same worker as the original file, and the JAX copy on
the same process-global state, so every published test, on either
package, runs isolated from what ran before it (``_isolated``):

- the package's flag registry (``butil/flags.py _registry``) is taken as
  it stands before the test, keys and values, and put back after it: each
  flag it held, with its value; the flags that the file itself defines by
  literal name (``test_flag_x``, ``test_flag_frozen`` and
  ``test_flag_listed`` in ``tests/test_butil.py``) are absent while the
  test runs and after it, so a define returns a fresh flag at its default,
  not the one an earlier run of the same body left set.  A flag that a
  module defined at its first import during the test stays, as the module
  stays imported;
- the settings in ``_SETTINGS`` are saved and put back: the usercode
  pool's default kind (``rpc/usercode_pool.py _default_kind``, pinned by
  rpc_press's ``--usercode-pool``).  The ``ici_fabric_*`` and
  ``ici_shm_stripes`` values that rpc_press's ``--bulk-plane`` and
  ``--shm-stripes`` set are flags, so the registry's snapshot covers them.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import inspect
import os
import re
import sys
import time
import types
from typing import Dict, Iterable, Optional, Tuple

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a module path of the JAX package; ``brpc_tpu.Trace``/``brpc_tpu.Builtin``
# (a capital after the dot) are service names on the wire, which the two
# packages share
_PKG = re.compile(r"\bbrpc_tpu\b(?!_torch)(?!\.[A-Z])")
_OWN_FLAG = re.compile(r"define_flag\(\s*[\"'](\w+)[\"']")
# (module under the package, attribute): process-global settings a
# mirrored file's tests change and do not always put back
_SETTINGS = (("rpc.usercode_pool", "_default_kind"),)


@contextlib.contextmanager
def _isolated(package: str, own_flags: Tuple[str, ...],
              cpu_mesh: bool = False):
    """Run a test body on ``package``'s flag registry and settings as they
    stand, without the file's own flags ``own_flags``, and put both back
    after it.  With ``cpu_mesh`` the port's default mesh is a fresh
    8-rank CPU mesh while it runs (the JAX copy's default is the CPU
    platform's 8 devices), and the default before it is put back."""
    flags = importlib.import_module(f"{package}.butil.flags")
    with flags._registry_lock:
        kept = dict(flags._registry)
        for name in own_flags:
            flags._registry.pop(name, None)
    values = {name: f.value for name, f in kept.items()}
    settings = []
    for mod_name, attr in _SETTINGS:
        mod = importlib.import_module(f"{package}.{mod_name}")
        settings.append((mod, attr, getattr(mod, attr)))
    mesh_cls = mesh_before = None
    if cpu_mesh and package == "brpc_tpu_torch":
        mesh_cls = importlib.import_module(f"{package}.ici.mesh").IciMesh
        mesh_before = mesh_cls._default
        mesh_cls.set_default(mesh_cls(ranks=8, device="cpu"))
    try:
        yield
    finally:
        if mesh_cls is not None:
            mesh_cls.set_default(mesh_before)
        with flags._registry_lock:
            for name in own_flags:
                flags._registry.pop(name, None)
            flags._registry.update(kept)
        for name, f in kept.items():
            with f._lock:
                f.value = values[name]
        for mod, attr, value in settings:
            setattr(mod, attr, value)


def load(path: str, port: bool,
         swaps: Iterable[Tuple[str, str]] = ()) -> types.ModuleType:
    """The test module at ``path`` (relative to the repo), on the JAX
    package or, with ``port``, on the port."""
    full = os.path.join(REPO, path)
    with open(full) as f:
        src = f.read()
    if port:
        for old, new in swaps:
            assert old in src, f"{path}: {old!r} not found"
            src = src.replace(old, new)
        src = _PKG.sub("brpc_tpu_torch", src)
    stem = os.path.splitext(os.path.basename(path))[0]
    name = f"tests._mirror_{'port' if port else 'jax'}_{stem}"
    mod = types.ModuleType(name)
    mod.__file__ = full
    mod.__package__ = "tests"
    sys.modules[name] = mod
    mod._mirror_own_flags = tuple(sorted(set(_OWN_FLAG.findall(src))))
    mod._mirror_package = "brpc_tpu_torch" if port else "brpc_tpu"
    exec(compile(src, full, "exec"), mod.__dict__)
    # the copies run beside the original module in one worker: names
    # they register (mem:// listeners) must not collide with its own
    for counter in ("_seq",):
        seq = mod.__dict__.get(counter)
        if isinstance(seq, list) and seq and isinstance(seq[0], int):
            seq[0] += 100_000 if port else 200_000
    return mod


def mirror(path: str, namespace: Dict[str, object],
           swaps: Iterable[Tuple[str, str]] = (),
           names: Optional[Iterable[str]] = None, prefix: str = "",
           cpu_mesh: bool = False) -> None:
    """Publish the tests of ``path`` on both packages into ``namespace``
    (a test module's ``globals()``): every test class and module-level
    test, or only the classes ``names``, as ``Test<prefix><Name>Jax`` /
    ``...Port`` (``test_<name>_jax`` / ``..._port``).  ``cpu_mesh``: the
    port's copy runs on a CPU default mesh (``_isolated``)."""
    for port in (False, True):
        mod = load(path, port, swaps)
        tag = "Port" if port else "Jax"
        isolated = functools.partial(_isolated, mod._mirror_package,
                                     mod._mirror_own_flags, cpu_mesh)
        fixtures = _module_fixtures(mod)
        for key, obj in list(mod.__dict__.items()):
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if names is not None and key not in names:
                continue
            if key.startswith("Test") and isinstance(obj, type):
                name = f"Test{prefix}{key[4:]}{tag}"
                namespace[name] = type(name, (obj,), {
                    **{k: v for k, v in fixtures.items()
                       if not hasattr(obj, k)},
                    "__module__": namespace["__name__"],
                    "_mirror_isolation": _isolation_fixture(isolated)})
            elif key.startswith("test_") and callable(obj):
                namespace[f"{key}_{tag.lower()}"] = _isolated_test(
                    obj, isolated, fixtures, tag.lower(), namespace)


def _module_fixtures(mod: types.ModuleType) -> Dict[str, object]:
    """The module-level fixtures of a loaded copy (``mesh``, ``fan4``), as
    fixtures of its published classes: the two copies each define theirs
    under one name, and a class looks its fixtures up on itself first."""
    from _pytest.fixtures import getfixturemarker
    out = {}
    for key, obj in mod.__dict__.items():
        marker = getfixturemarker(obj)
        if marker is None or getattr(obj, "__module__", None) != mod.__name__:
            continue
        raw = obj._get_wrapped_function()
        if inspect.isgeneratorfunction(raw):
            def method(self, *a, _raw=raw, **k):
                yield from _raw(*a, **k)
        else:
            def method(self, *a, _raw=raw, **k):
                return _raw(*a, **k)
        sig = inspect.signature(raw)
        method.__signature__ = sig.replace(parameters=[
            inspect.Parameter("self", inspect.Parameter.POSITIONAL_ONLY),
            *sig.parameters.values()])
        method.__name__ = method.__qualname__ = key
        out[key] = pytest.fixture(
            method, scope=marker.scope, params=marker.params,
            autouse=marker.autouse, ids=marker.ids, name=marker.name)
    return out


def _isolation_fixture(isolated):
    """An autouse fixture for a published class: each of its tests runs
    inside ``isolated()``."""
    @pytest.fixture(autouse=True)
    def _mirror_isolation(self):
        with isolated():
            yield
    return _mirror_isolation


def _isolated_test(fn, isolated, fixtures=None, tag="", namespace=None):
    """A module-level test that runs inside ``isolated()``; pytest reads
    its fixtures through ``__wrapped__``.

    A test that takes one of its copy's module-level fixtures (``fan4``)
    takes it as ``<name>_<tag>``, published into ``namespace`` once per
    copy (the two copies each define theirs under one name), after an
    isolation fixture, ``_mirror_isolation_<tag>``, that it takes first:
    the fixture's set-up (servers on the CPU default mesh) runs isolated
    too."""
    params = inspect.signature(fn).parameters
    own = [name for name in params if name in (fixtures or {})]
    if not own:
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with isolated():
                return fn(*args, **kwargs)
        return run
    guard = f"_mirror_isolation_{tag}"
    if guard not in namespace:
        @pytest.fixture(name=guard)
        def _guard():
            with isolated():
                yield
        namespace[f"_fixture{guard}"] = _guard
    for name in own:
        published = f"{name}_{tag}"
        if f"_fixture_{published}" not in namespace:
            namespace[f"_fixture_{published}"] = _module_level_fixture(
                fixtures[name], published, guard)
    renamed = {f"{name}_{tag}": name for name in own}

    @functools.wraps(fn)
    def run(*args, **kwargs):
        kwargs.pop(guard, None)
        for new, old in renamed.items():
            if new in kwargs:
                kwargs[old] = kwargs.pop(new)
        return fn(*args, **kwargs)
    run.__signature__ = inspect.Signature(
        [inspect.Parameter(guard, inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        + [p.replace(name=f"{p.name}_{tag}") if p.name in own else p
           for p in params.values()])
    return run


def _module_level_fixture(method_fixture, name, guard):
    """The module-level fixture ``name`` of one copy, from its class-level
    form (``_module_fixtures``), set up after the isolation fixture
    ``guard``; its own parameters are fixtures the copy's tests see."""
    raw = method_fixture._get_wrapped_function()
    sig = inspect.signature(raw)
    params = [p for p in sig.parameters.values() if p.name != "self"]
    if inspect.isgeneratorfunction(raw):
        def body(*a, **k):
            k.pop(guard, None)
            yield from raw(None, *a, **k)
    else:
        def body(*a, **k):
            k.pop(guard, None)
            return raw(None, *a, **k)
    body.__signature__ = inspect.Signature(
        [inspect.Parameter(guard, inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        + params)
    body.__name__ = body.__qualname__ = name
    return pytest.fixture(body, name=name)


@pytest.fixture(scope="module", autouse=True)
def drain_sockets():
    """Every connection a module's port servers and channels opened is
    gone at its end (import this fixture into the test module)."""
    yield
    from brpc_tpu_torch.rpc.socket import list_sockets
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and list_sockets():
        gc.collect()
        time.sleep(0.02)
    assert not list_sockets()
