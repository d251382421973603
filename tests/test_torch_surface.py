"""The census of the port's public surface.

For every ``brpc_tpu/**.py`` the port has a file at the same path under
``brpc_tpu_torch/``, and every public name of the JAX file has a
counterpart there: each public top-level function and class, each
public method (properties included) of a class, and each annotated
class-level field (a dataclass's fields, a controller's class defaults).
A class member counts as present when the port's class has it (its own
or inherited), declares it as a dataclass field, or assigns it as
``self.<name>`` in a class of its MRO.  The same holds for every flag
the JAX package defines with ``define_flag("...")``, and for the
keywords of the options classes listed in ``ALLOWED_KEYWORDS``.

A package's ``__init__.py`` binds names by import, and those are checked
apart: for every ``brpc_tpu/**/__init__.py``, a fresh interpreter imports
the port's package at the same path alone (so no earlier import can
have bound a submodule as a side effect) and finds each name the JAX
file binds (``from .x import a``, ``from . import x``): a re-exported
function or class, or a submodule, which must be the port's submodule
of that name.  A binding the port cannot have goes on
``ALLOWED_BINDINGS`` with its reason.

A name the census finds present is not thereby held to the JAX
meaning: ``tests/test_torch_surface_parity.py`` runs the names this
census brought into the port through both packages on the same inputs.

What the port cannot have sits on an allowlist below, each entry with
its reason; an allowlisted name must still be in the JAX package and
still be absent from the port, so the list cannot go stale.  A name
added to the JAX package later fails the census until it is ported or
allowlisted.
"""
from __future__ import annotations

import ast
import functools
import importlib
import inspect
import json
import os
import re
import subprocess
import sys
from typing import List, Optional, Tuple

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "brpc_tpu")
PORT_ROOT = os.path.join(REPO, "brpc_tpu_torch")

_SHARDING = ("a jax.sharding.NamedSharding over the JAX mesh; the port's "
             "layouts are types of their own: ShardedTensor (one row per "
             "rank, ici/mesh.py) and a plain tensor on mesh.device(0) for "
             "a replicated value")
_NATIVE_SCHED = ("the JAX native loader's fiber-scheduler bindings; the "
                 "port schedules in Python (bthread/scheduler.py) and no "
                 "port module needs the C++ fibers (ROADMAP queue 1)")
_NO_READER = ("nothing in brpc_tpu/ reads it, so it has no meaning to "
              "port; a server authenticates through ServerOptions.auth "
              "(policy/tpu_std.py, policy/grpc.py)")
_DEVICE_INDEX = ("maps a JAX device to its one rank; in the port a device "
                 "names no rank, since every rank of a one-card mesh sits "
                 "on that card (and every rank of a CPU mesh on the CPU): "
                 "a tensor's rank is IciMesh.rank_of, which "
                 "device_plane.mesh_index_of reads")
_XFER = ("the JAX node's transfer-server connection cache and staging "
         "(jax.experimental.transfer); the port's kind 1 pulls a staged "
         "row through ici/ipc_pull.py and dials no transfer server")
_BULK = ("the legacy single-plane bulk reservation that the JAX stream "
         "reaches through getattr (brpc_tpu/rpc/stream.py:388-495); the "
         "port's stream takes the same frames through stream_fast_begin/"
         "stream_fast_send/stream_fast_abort (brpc_tpu_torch/ici/"
         "fabric.py) and claims them with stream_bulk_claim")

# (file under the package, name or Class.member): the reason the port has
# no counterpart
ALLOWED = {
    ("butil/jax_compat.py", "<file>"):
        "adapts the JAX package to JAX versions; the port imports no JAX",
    ("ici/mesh.py", "IciMesh.sharding"): _SHARDING,
    ("ici/mesh.py", "IciMesh.shard_along_axis"): _SHARDING,
    ("ici/mesh.py", "IciMesh.device_index"): _DEVICE_INDEX,
    ("rpc/protocol.py", "Protocol.verify"): _NO_READER,
    ("rpc/controller.py", "Controller.request_protocol"):
        "nothing in brpc_tpu/ writes or reads it, so it has no meaning to "
        "port",
    ("butil/native.py", "NativeScheduler"): _NATIVE_SCHED,
    ("butil/native.py", "NativeScheduler.selftest"): _NATIVE_SCHED,
    ("butil/native.py", "NativeScheduler.completed"): _NATIVE_SCHED,
    ("butil/native.py", "NativeScheduler.spawned"): _NATIVE_SCHED,
    ("ici/fabric.py", "FabricNode.xfer_connection"): _XFER,
    ("ici/fabric.py", "FabricNode.stage"): _XFER,
    ("ici/fabric.py", "FabricSocket.stream_bulk_begin"): _BULK,
    ("ici/fabric.py", "FabricSocket.stream_bulk_send"): _BULK,
    ("ici/fabric.py", "FabricSocket.stream_bulk_abort"): _BULK,
}

# (file, options class, keyword) the JAX class takes and the port's does
# not, each with its reason
_JSON_IGNORED = ("the JAX pb_to_json accepts it and passes it nowhere: "
                 "json_format always prints bytes as base64 and prints an "
                 "empty repeated field only under "
                 "always_print_primitive_fields")
ALLOWED_KEYWORDS = {
    ("codec/json2pb.py", "Pb2JsonOptions", "bytes_to_base64"): _JSON_IGNORED,
    ("codec/json2pb.py", "Pb2JsonOptions", "jsonify_empty_array"):
        _JSON_IGNORED,
}

# JAX flags with no port definition, each with its reason (ROADMAP queue 1)
ALLOWED_FLAGS = {
    "ici_fused_dispatch":
        "the JAX native plane's fused dispatch; the port's native door "
        "dispatches each call on its own",
    "ici_upcall_max_batch":
        "the JAX native plane's upcall batching; the port makes no "
        "batched upcalls",
    "ici_upcall_batch_age_us":
        "the JAX native plane's upcall batching; the port makes no "
        "batched upcalls",
    "ici_device_plane_kernel":
        "picks the JAX package's own transfer program; the port has one "
        "kernel, p2p_copy",
    "ici_device_plane_xproc":
        "always on in the port: the kind-4 leg (brpc_tpu_torch/ici/"
        "fabric.py)",
    "ici_fabric_health_check":
        "always on in the port: the health check starts at a client "
        "socket's death",
    "ici_device_plane_retry_s":
        "a constant in the port (DEVICE_RETRY_S)",
    "serving_compiled_step":
        "the compiled decode step, a perf_opt PR after the benchmark "
        "(ROADMAP queue 5)",
    "ici_fanout_cache_max":
        "the compiled fan-out's program cache, a perf_opt PR after the "
        "benchmark (ROADMAP queue 5)",
}


# (package under brpc_tpu, bound name): the reason the port's package
# does not bind it
ALLOWED_BINDINGS: dict = {}


def _jax_files() -> List[str]:
    out = []
    for root, _dirs, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_ROOT))
    return sorted(out)


def public_names(path: str) -> List[Tuple[str, Optional[str], int]]:
    """(top-level name, member or None, line) of every public name of a
    JAX file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.append((node.name, None, node.lineno))
        elif isinstance(node, ast.ClassDef):
            if not node.name.startswith("_"):
                out.append((node.name, None, node.lineno))
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    name = m.name
                elif isinstance(m, ast.AnnAssign) \
                        and isinstance(m.target, ast.Name):
                    name = m.target.id
                else:
                    continue
                if not name.startswith("_"):
                    out.append((node.name, name, m.lineno))
    return out


@functools.lru_cache(maxsize=None)
def _self_attrs(cls) -> frozenset:
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return frozenset()
    return frozenset(re.findall(r"self\.(\w+)\s*(?::[^=\n]*)?=", src))


def _has_member(cls, member: str) -> bool:
    return (hasattr(cls, member)
            or member in getattr(cls, "__dataclass_fields__", {})
            or any(member in _self_attrs(k)
                   for k in getattr(cls, "__mro__", ())))


def _port_module(rel: str):
    name = "brpc_tpu_torch." + rel[:-3].replace(os.sep, ".")
    if name.endswith(".__init__"):
        name = name[:-len(".__init__")]
    return importlib.import_module(name)


def missing_in_port(rel: str) -> List[Tuple[str, int]]:
    """(name, JAX line) of each public name of ``brpc_tpu/<rel>`` with no
    counterpart in the port."""
    names = public_names(os.path.join(JAX_ROOT, rel))
    if not os.path.exists(os.path.join(PORT_ROOT, rel)):
        return [("<file>", 1)]
    mod = _port_module(rel)
    out = []
    for top, member, line in names:
        if member is None:
            if not hasattr(mod, top):
                out.append((top, line))
            continue
        cls = getattr(mod, top, None)
        if cls is None or not _has_member(cls, member):
            out.append((f"{top}.{member}", line))
    return out


@pytest.mark.parametrize("rel", _jax_files())
def test_public_names_have_a_port_counterpart(rel):
    gaps = [(name, line) for name, line in missing_in_port(rel)
            if (rel, name) not in ALLOWED]
    assert not gaps, (f"brpc_tpu/{rel}: no port counterpart (name, JAX "
                      f"line): {gaps}")


@pytest.mark.parametrize("rel,name", sorted(ALLOWED))
def test_allowlisted_name_is_still_jax_only(rel, name):
    assert ALLOWED[(rel, name)]
    assert name in {n for n, _ in missing_in_port(rel)}, (
        f"{rel} {name} is ported now: take it off the allowlist")


def _flags(root: str) -> set:
    found = set()
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    found.update(re.findall(
                        r"define_flag\(\s*[\"'](\w+)[\"']", fh.read()))
    return found


def test_every_jax_flag_is_defined_by_the_port_or_allowlisted():
    missing = _flags(JAX_ROOT) - _flags(PORT_ROOT)
    assert missing == set(ALLOWED_FLAGS), (
        sorted(missing - set(ALLOWED_FLAGS)),
        sorted(set(ALLOWED_FLAGS) - missing))


def _keywords(cls) -> set:
    return set(inspect.signature(cls.__init__).parameters) - {"self"}


@pytest.mark.parametrize("rel,cls,kw", sorted(ALLOWED_KEYWORDS))
def test_allowlisted_keyword_is_still_jax_only(rel, cls, kw):
    assert ALLOWED_KEYWORDS[(rel, cls, kw)]
    jax_mod = importlib.import_module(
        "brpc_tpu." + rel[:-3].replace(os.sep, "."))
    assert kw in _keywords(getattr(jax_mod, cls))
    assert kw not in _keywords(getattr(_port_module(rel), cls)), (
        f"{rel} {cls}({kw}=) is ported now: take it off the allowlist")


@pytest.mark.parametrize("rel,cls", sorted(
    {(rel, cls) for rel, cls, _ in ALLOWED_KEYWORDS}))
def test_options_keywords_have_a_port_counterpart(rel, cls):
    jax_mod = importlib.import_module(
        "brpc_tpu." + rel[:-3].replace(os.sep, "."))
    gaps = (_keywords(getattr(jax_mod, cls))
            - _keywords(getattr(_port_module(rel), cls))
            - {kw for r, c, kw in ALLOWED_KEYWORDS if (r, c) == (rel, cls)})
    assert not gaps, f"brpc_tpu/{rel} {cls}: keywords {sorted(gaps)}"


def init_bindings(path: str) -> List[Tuple[str, Optional[str], int]]:
    """(bound name, submodule or None, line) of every name a JAX
    ``__init__.py`` binds by a relative import: ``from . import x as y``
    binds ``y`` to the submodule ``x``, ``from .x import a`` binds ``a``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom) or node.level != 1:
            continue
        for alias in node.names:
            bound = alias.asname or alias.name
            sub = alias.name if node.module is None else None
            out.append((bound, sub, node.lineno))
    return out


def _packages() -> List[str]:
    return [os.path.dirname(rel) for rel in _jax_files()
            if os.path.basename(rel) == "__init__.py"]


# run in a fresh interpreter: the port's package imported alone, then for
# each (bound name, submodule) whether it is bound, and bound to the
# port's submodule of that name where the JAX file binds a submodule
_PROBE = """
import importlib, json, sys, types
pkg = sys.argv[1]
mod = importlib.import_module(pkg)
out = []
for name, sub in json.loads(sys.argv[2]):
    if not hasattr(mod, name):
        out.append([name, "unbound"])
    elif sub is not None and not (
            isinstance(getattr(mod, name), types.ModuleType)
            and getattr(mod, name).__name__ == pkg + "." + sub):
        out.append([name, "not the port's submodule " + sub])
print(json.dumps(out))
"""


@pytest.mark.parametrize("pkg", _packages())
def test_init_bindings_have_a_port_counterpart(pkg):
    rel = os.path.join(pkg, "__init__.py")
    bindings = init_bindings(os.path.join(JAX_ROOT, rel))
    if not bindings:
        return
    port_pkg = ".".join(["brpc_tpu_torch"] + ([pkg.replace(os.sep, ".")]
                                               if pkg else []))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, port_pkg,
         json.dumps([[name, sub] for name, sub, _ in bindings])],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    found = {name: why for name, why in json.loads(res.stdout)}
    gaps = [(name, why) for name, why in found.items()
            if (pkg, name) not in ALLOWED_BINDINGS]
    assert not gaps, (f"brpc_tpu/{rel}: bindings the port's package "
                      f"lacks after a fresh import: {gaps}")
    stale = [name for p, name in ALLOWED_BINDINGS
             if p == pkg and name not in found]
    assert not stale, f"{rel} binds {stale} now: take them off the allowlist"
