"""fablint: concurrency static analysis for the brpc_tpu_torch package.

The fabric is deeply concurrent (ici/fabric.py alone holds a dozen
locks) and its reviews keep catching the same bug classes by hand:
unguarded shared state, lock-order inversions, blocking calls under a
held lock, and thread-owning objects with no quiesce path.  The
reference ships
this as doctrine plus sanitizer builds (docs/en/io.md, TSan/ASan in its
CI); fablint is the machine-checkable half for the Python layer — the
moral equivalent of clang's thread-safety annotations
(``GUARDED_BY``/``EXCLUSIVE_LOCKS_REQUIRED``) for a codebase the clang
analyzer cannot see.

Passes (default command)
------------------------

``guarded-state``
    Attributes declared in a per-class ``_GUARDED_BY = {"_attr":
    "_lock"}`` map may only be read/written lexically inside ``with
    <base>.<lock>:`` where ``<base>`` is the same receiver (``self``,
    or e.g. ``peer`` for cross-object access), or inside a method
    marked ``# fablint: lock-held(<lock>)`` (callers hold it).
    ``__init__`` and methods marked ``# fablint: init`` are exempt
    (object not yet shared).  Module-level names declared in
    ``_GUARDED_BY_GLOBALS = {"_name": "_name_lock"}`` must be accessed
    inside ``with <lock>:`` from any function in that module.

``lock-order``
    Nested ``with``-lock acquisitions are extracted per module into a
    global acquisition graph; any cycle fails the lint.  Lock identity
    is ``Class.attr`` for ``self``/``cls`` locks, ``module:name`` for
    module-level locks (import aliases resolved), ``~attr`` for locks
    reached through another object.

``blocking-under-lock``
    Calls that can block the calling thread — ``.join()``,
    ``time.sleep``, socket ``recv``/``accept``/``connect``/
    ``create_connection``, ``subprocess.*`` (the nvcc and g++ builds),
    the host's wait on the card (``torch.cuda.synchronize``,
    ``Stream.synchronize``, ``Event.synchronize``), the names the
    reference's JAX calls block in (``device_put``/``jit``), the
    coordination-service ``blocking_key_value_get`` —
    are flagged when they appear lexically inside a held-lock region.

``thread-hygiene``
    Every ``threading.Thread(...)`` spawn must pass ``daemon=True``
    AND have a quiesce path: either the thread handle is ``.join()``ed
    somewhere in the module, or the spawn carries a ``# fablint:
    thread-quiesced(<how>)`` marker naming its shutdown mechanism.
    This is the exit-race class: static destructors, or an interpreter
    finalizing, racing live reader threads.

``plane-state``
    Per-plane health bookkeeping lives in ONE place
    (``ici/plane_health.py``).  Any module OTHER than
    that file that (a) assigns a per-plane state field on ``self``/
    ``cls`` — ``_reestab_wanted``/``_running`` (plain or ``_shm_``-
    prefixed), ``_down``, ``_down_reason``, ``_down_epoch``,
    ``_down_at``, or any ``*_down_until`` latch — or (b) spawns a
    ``threading.Thread`` whose target name says revive/reestablish/
    reprobe, is growing a FIFTH hand-rolled health machine; the fix is
    ``plane_health.register_plane(...)`` with the plane keeping only
    its mechanics (dial, handshake payload, teardown).

Custody passes (``custody`` subcommand)
-------------------------------------------------

The reference's correctness doctrine is custody discipline: Socket
fails exactly once, resource_pool hands out versioned ids, every pin /
parked handle has exactly one exit.  Custody-carrying classes (or
modules) declare their protocol::

    _CUSTODY = {"pin": ("unpin",),                  # acquire method
                "_refs": ("_free_session_locked",),  # refcount field
                }

``custody``
    Path-sensitive acquire/release: every lexical acquisition — a
    declared acquire call (``pool.pin(s)``, ``blocks, old =
    self._reserve_locked(...)``, ``if not pool.pin(s): return``), or a
    ``+= 1`` on a declared refcount field — must reach, on every exit
    path INCLUDING exception edges, one of: a matching release, an
    explicit transfer marked ``# fablint: custody-moved(<to>)
    <reason>``, or a return of the owning object.  A statement that can
    raise while custody is held must sit under a ``try`` whose broad
    handler or ``finally`` releases.  The analysis is lexical and
    per-function: class declarations match ``self`` receivers inside
    the declaring class plus receivers whose name shares a token with
    the class name (``pool.pin`` matches ``PagedKvPool``); module-level
    ``_CUSTODY`` maps match only their own module.  Known benign calls
    (builtins, container methods) are not exception edges.

``refcount-balance``
    Every ``±1`` on a declared refcount field must sit under the
    field's ``_GUARDED_BY`` lock (any held lock if undeclared, or a
    ``lock-held`` marker), and every decrement site must dominate a
    zero-check that frees — ``r = refs.get(b, 1) - 1`` followed by
    ``if r <= 0: refs.pop(...)``, a decrement under an
    ``if refs.get(b, 1) > 1:`` guard, or ``x -= 1`` followed by an
    ``if not x ...: free()`` — or carry a reasoned suppression.

The runtime complement is ``butil/custody_ledger.py`` (``debug_custody``
flag): declared acquire/release points record stack-tagged ledger
entries, so a leak that rides a ``custody-moved`` transfer whose far
end never fires is attributed to its acquiring file:line at runtime.

Dead-code passes (``deadcode`` subcommand)
------------------------------------------

``dead-import``      imports never referenced in the module
                     (``__init__.py`` re-export modules are skipped;
                     ``# noqa`` honored).
``unreachable``      statements after return/raise/break/continue, and
                     ``if False:`` / ``while False:`` bodies.
``dead-global``      private (``_``-prefixed) module-level assignments
                     never read in their module and not in ``__all__``
                     (public names may be imported elsewhere, so only
                     private ones are provably dead).

Suppressions and markers
------------------------

``# fablint: ignore[rule1,rule2] <reason>``
    Suppresses those rules on that line.  The reason is REQUIRED —
    a reason-less ignore is itself reported (``bad-suppression``), so
    the accepted-findings baseline stays explicit and reviewed.
``# fablint: lock-held(_lock)``      method runs with self._lock held
``# fablint: init``                  constructor-path method, exempt
``# fablint: thread-quiesced(how)``  thread has a shutdown path
``# fablint: custody-moved(to) why`` ownership transferred to <to>; the
                                     reason is REQUIRED, like ignore[]

CLI
---

    python -m brpc_tpu_torch.tools.fablint [paths...] [--json]
    python -m brpc_tpu_torch.tools.fablint deadcode [paths...] [--json]
    python -m brpc_tpu_torch.tools.fablint custody [paths...] [--json]
    python -m brpc_tpu_torch.tools.fablint all [paths...] [--json]
    python -m brpc_tpu_torch.tools.fablint all --rules custody,lock-order ...

``--rules a,b`` restricts any command to the named rules (CI bisection:
a new rule can be vetted without muting the rest).  Exit status 1 when
findings exist, 0 when clean.  Default path: the brpc_tpu_torch package this
module lives in.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import sys
import tokenize
from typing import Dict, List, Optional, Set, Tuple

CONCURRENCY_RULES = ("guarded-state", "lock-order", "blocking-under-lock",
                     "thread-hygiene", "plane-state", "bad-suppression")
CUSTODY_RULES = ("custody", "refcount-balance")
DEADCODE_RULES = ("dead-import", "unreachable", "dead-global")
ALL_RULES = CONCURRENCY_RULES + CUSTODY_RULES + DEADCODE_RULES

# terminal callee names that can block the calling thread (pass 3).
# ``wait`` is deliberately absent: Condition.wait releases the lock it
# is called under, and butex waits park the tasklet, not the lock.
_BLOCKING_NAMES = {
    "sleep", "recv", "recvfrom", "recv_into", "accept", "connect",
    "create_connection", "device_put", "blocking_key_value_get",
    "jit", "getaddrinfo", "gethostbyname",
    # the port's host-side wait on the card: torch.cuda.synchronize(),
    # Stream.synchronize(), Event.synchronize() (the counterpart of the
    # reference's device_put / jit)
    "synchronize",
}
_SUBPROCESS_NAMES = {"run", "Popen", "check_output", "check_call", "call"}

# large-copy callees: a block-sized tobytes /
# copyto / array_equal under a held lock serializes every other holder
# behind a memcpy — the demote-copy debt class.  Accepted sites
# carry reasoned suppressions so the debt stays visible in-tree.
_LARGE_COPY_NAMES = {"tobytes", "copyto", "array_equal"}

_LOCKISH_RE = re.compile(r"lock|mutex", re.IGNORECASE)

# custody pass: calls that are not exception edges for the lexical
# acquire/release analysis — builtins and container/dict methods whose
# failure modes (MemoryError, a KeyError on a missing key the code
# just checked) are interpreter-level, not resource-path-level.  A
# deliberately small list: anything else that can raise between an
# acquire and its release needs try coverage.
_BENIGN_CALLS = {
    "range", "len", "enumerate", "zip", "int", "float", "str", "bool",
    "bytes", "min", "max", "abs", "list", "tuple", "set", "dict",
    "sorted", "reversed", "isinstance", "getattr", "hasattr", "id",
    "iter", "next", "repr", "bin",
}
_BENIGN_METHODS = {
    "get", "pop", "popleft", "append", "appendleft", "add", "discard",
    "remove", "extend", "sort", "setdefault", "update", "clear",
    "items", "keys", "values", "copy",
}
# receivers whose method calls are edge-benign: the runtime custody
# ledger's own hooks are no-op instrumentation (flag-gated early-out),
# never a raise site between an acquire and its release
_BENIGN_ROOTS = {"_ledger", "custody_ledger"}
_BROAD_EXC_NAMES = {"Exception", "BaseException"}
_FREEISH_RE = re.compile(
    r"free|pop|release|unregister|return|evict|clear|discard|del",
    re.IGNORECASE)

# pass 5 (plane-state): the field names the four older health
# machines used — re-declaring one outside plane_health.py is the
# signature of a new hand-rolled machine, and the revival-thread regex
# catches the loop that always comes with it
_PLANE_STATE_RE = re.compile(
    r"^(?:_(?:shm_)?reestab_(?:wanted|running)|_down|_down_reason|"
    r"_down_epoch|_down_at|\w*_down_until)$")
_PLANE_THREAD_RE = re.compile(r"revive|reestab|reprobe", re.IGNORECASE)
_PLANE_HEALTH_BASENAME = "plane_health.py"

_DIRECTIVE_RE = re.compile(r"#\s*fablint:\s*(.*)$")
_IGNORE_RE = re.compile(r"ignore\[([\w\-, ]+)\]\s*(.*)$")
_LOCK_HELD_RE = re.compile(r"lock-held\(([\w, ]+)\)")
_THREAD_QUIESCED_RE = re.compile(r"thread-quiesced\(([^)]*)\)")
_CUSTODY_MOVED_RE = re.compile(r"custody-moved\(([^)]*)\)\s*(.*)$")
_INIT_RE = re.compile(r"\binit\b")


class Finding:
    __slots__ = ("rule", "path", "line", "message")

    def __init__(self, rule: str, path: str, line: int, message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class _Directives:
    """Per-module comment directives, keyed by line number."""

    def __init__(self, source: str, path: str):
        self.ignores: Dict[int, Tuple[Set[str], str]] = {}
        self.lock_held: Dict[int, List[str]] = {}
        self.init_marks: Set[int] = set()
        self.thread_quiesced: Dict[int, str] = {}
        self.custody_moved: Dict[int, Tuple[str, str]] = {}   # (to, why)
        self.noqa: Set[int] = set()
        self.bad: List[Tuple[int, str]] = []     # reason-less ignores etc.
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                line = tok.start[0]
                text = tok.string
                if "noqa" in text:
                    self.noqa.add(line)
                m = _DIRECTIVE_RE.search(text)
                if not m:
                    continue
                body = m.group(1).strip()
                im = _IGNORE_RE.match(body)
                if im:
                    rules = {r.strip() for r in im.group(1).split(",")
                             if r.strip()}
                    reason = im.group(2).strip()
                    if not reason:
                        self.bad.append(
                            (line, "ignore[] without a reason — every "
                                   "suppression must say why"))
                    self.ignores[line] = (rules, reason)
                    continue
                lm = _LOCK_HELD_RE.match(body)
                if lm:
                    self.lock_held[line] = [x.strip() for x in
                                            lm.group(1).split(",") if x.strip()]
                    continue
                tm = _THREAD_QUIESCED_RE.match(body)
                if tm:
                    self.thread_quiesced[line] = tm.group(1).strip()
                    continue
                cm = _CUSTODY_MOVED_RE.match(body)
                if cm:
                    to = cm.group(1).strip()
                    why = cm.group(2).strip()
                    if not why:
                        self.bad.append(
                            (line, "custody-moved() without a reason — "
                                   "every ownership transfer must say "
                                   "who releases and why"))
                    self.custody_moved[line] = (to, why)
                    continue
                if _INIT_RE.match(body):
                    self.init_marks.add(line)
                    continue
                self.bad.append((line, f"unknown fablint directive: {body!r}"))
        except tokenize.TokenError:
            pass

    def suppressed(self, rule: str, line: int) -> bool:
        ent = self.ignores.get(line)
        return ent is not None and (rule in ent[0] or "all" in ent[0])

    def _def_marker(self, table, node):
        """A def-attached marker sits on the def line or the line above
        (above a decorator counts too)."""
        first = min([node.lineno] + [d.lineno for d in
                    getattr(node, "decorator_list", [])])
        for ln in (node.lineno, first - 1, node.lineno - 1):
            if ln in table:
                return table[ln]
        return None

    def fn_lock_held(self, node) -> List[str]:
        return self._def_marker(self.lock_held, node) or []

    def fn_is_init(self, node) -> bool:
        first = min([node.lineno] + [d.lineno for d in
                    getattr(node, "decorator_list", [])])
        return bool({node.lineno, first - 1, node.lineno - 1}
                    & self.init_marks)

    def thread_marker(self, lineno: int) -> Optional[str]:
        for ln in (lineno, lineno - 1):
            if ln in self.thread_quiesced:
                return self.thread_quiesced[ln]
        return None

    def moved_marker(self, *linenos: int) -> Optional[Tuple[str, str]]:
        """custody-moved on any of the given lines or the line above
        the first (multi-line acquire statements put the marker where
        it fits)."""
        cands = list(linenos) + [linenos[0] - 1] if linenos else []
        for ln in cands:
            if ln in self.custody_moved:
                return self.custody_moved[ln]
        return None


def _literal_str_dict(node: ast.AST) -> Optional[Dict[str, str]]:
    if not isinstance(node, ast.Dict):
        return None
    out = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Constant) and isinstance(v.value, str)):
            return None
        out[k.value] = v.value
    return out


def _literal_custody_dict(node: ast.AST
                          ) -> Optional[Dict[str, Tuple[str, ...]]]:
    """``_CUSTODY = {"acquire": ("rel_a", "rel_b")}`` — keys str,
    values tuple/list of str."""
    if not isinstance(node, ast.Dict):
        return None
    out: Dict[str, Tuple[str, ...]] = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, (ast.Tuple, ast.List))):
            return None
        rels = []
        for elt in v.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            rels.append(elt.value)
        out[k.value] = tuple(rels)
    return out


def _name_tokens(name: str) -> Set[str]:
    """CamelCase/underscore name → lowercase token set:
    ``PagedKvPool`` → {paged, kv, pool}; ``server_controller_pool`` →
    {server, controller, pool}.  Receiver-to-class matching runs on
    token overlap — lexical, honest, and documented."""
    return {t.lower()
            for t in re.findall(r"[A-Z]+[a-z0-9]*|[a-z0-9]+", name)}


class _CustodyRegistry:
    """Every ``_CUSTODY`` declaration across the sweep, merged by
    acquire name — the custody pass's phase-one output."""

    def __init__(self):
        # acquire/field name -> list of decl dicts
        self.by_name: Dict[str, List[dict]] = {}
        # (modname, class_name or None) -> every protocol method name
        # (acquires + releases): their BODIES are the implementation,
        # exempt from the acquire-release rule
        self.protocol: Dict[Tuple[str, Optional[str]], Set[str]] = {}

    def add(self, modname: str, class_name: Optional[str],
            cmap: Dict[str, Tuple[str, ...]]) -> None:
        names = self.protocol.setdefault((modname, class_name), set())
        for name, rels in cmap.items():
            names.add(name)
            names.update(rels)
            self.by_name.setdefault(name, []).append({
                "name": name, "releases": tuple(rels),
                "modname": modname, "class_name": class_name,
                "tokens": (_name_tokens(class_name)
                           if class_name else set()),
            })

    def exempt_fn(self, modname: str, class_name: Optional[str],
                  fn_name: str) -> bool:
        return (fn_name in self.protocol.get((modname, class_name), ())
                or fn_name == "__init__")


class _Held:
    """One lexically-held lock: (receiver base name or None for a
    module-level lock, lock name, canonical graph identity)."""

    __slots__ = ("base", "name", "canonical")

    def __init__(self, base: Optional[str], name: str, canonical: str):
        self.base = base
        self.name = name
        self.canonical = canonical


class ModuleLint:
    """All passes over one module; lock-order edges are merged globally
    by :func:`run`."""

    def __init__(self, path: str, source: str, modname: str):
        self.path = path
        self.source = source
        self.modname = modname
        self.tree = ast.parse(source, filename=path)
        # every node of the module, walked once: the passes below scan
        # the whole tree many times over
        self.nodes = list(ast.walk(self.tree))
        self._assigns = [n for n in self.nodes if isinstance(n, ast.Assign)]
        self._used: Optional[Set[str]] = None
        self.directives = _Directives(source, path)
        self.findings: List[Finding] = []
        # canonical lock id -> {canonical lock id -> (path, line)}
        self.lock_edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
        self.import_aliases = self._collect_import_aliases()
        self.class_guards = self._collect_class_guards()
        self.global_guards = self._collect_global_guards()
        self.custody_decls = self._collect_custody()
        self._known_locks = set(self.global_guards.values())
        for g in self.class_guards.values():
            self._known_locks.update(g.values())

    # ---- collection -----------------------------------------------------
    def _collect_import_aliases(self) -> Dict[str, str]:
        """Bound name -> 'resolved.module:orig' for from-imports, so a
        module-level lock imported under an alias keeps one identity."""
        out: Dict[str, str] = {}
        for node in self.nodes:
            if isinstance(node, ast.ImportFrom) and node.module is not None:
                mod = node.module
                if node.level:
                    parts = self.modname.split(".")
                    base = parts[:max(len(parts) - node.level, 0)]
                    mod = ".".join(base + [node.module])
                for alias in node.names:
                    out[alias.asname or alias.name] = f"{mod}:{alias.name}"
        return out

    def _collect_class_guards(self) -> Dict[str, Dict[str, str]]:
        out: Dict[str, Dict[str, str]] = {}
        for node in self.nodes:
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and stmt.targets[0].id == "_GUARDED_BY"):
                    d = _literal_str_dict(stmt.value)
                    if d is None:
                        self._report("guarded-state", stmt.lineno,
                                     "_GUARDED_BY must be a literal "
                                     "{str: str} dict")
                    else:
                        out[node.name] = d
        return out

    def _collect_custody(self) -> List[Tuple[Optional[str],
                                             Dict[str, Tuple[str, ...]]]]:
        """(class name or None for module scope, map) per _CUSTODY
        declaration; malformed maps report under the custody rule."""
        out: List[Tuple[Optional[str], Dict[str, Tuple[str, ...]]]] = []

        def grab(owner: Optional[str], stmt) -> None:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "_CUSTODY"):
                return
            d = _literal_custody_dict(stmt.value)
            if d is None:
                self._report("custody", stmt.lineno,
                             "_CUSTODY must be a literal {str: tuple-of-"
                             "str} dict")
            else:
                out.append((owner, d))

        for stmt in self.tree.body:
            grab(None, stmt)
        for node in self.nodes:
            if isinstance(node, ast.ClassDef):
                for stmt in node.body:
                    grab(node.name, stmt)
        return out

    def _collect_global_guards(self) -> Dict[str, str]:
        for stmt in self.tree.body:
            if (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "_GUARDED_BY_GLOBALS"):
                d = _literal_str_dict(stmt.value)
                if d is None:
                    self._report("guarded-state", stmt.lineno,
                                 "_GUARDED_BY_GLOBALS must be a literal "
                                 "{str: str} dict")
                    return {}
                return d
        return {}

    # ---- reporting ------------------------------------------------------
    def _report(self, rule: str, line: int, message: str) -> None:
        if self.directives.suppressed(rule, line):
            return
        self.findings.append(Finding(rule, self.path, line, message))

    # ---- lock identity --------------------------------------------------
    def _lockish(self, expr: ast.AST) -> Optional[Tuple[Optional[str], str]]:
        """(base name or None, lock name) when ``expr`` looks like a
        lock; None otherwise.  Calls (``self._dbd.read()``) never are."""
        if isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                            ast.Name):
            name = expr.attr
        else:
            return None
        if not (_LOCKISH_RE.search(name) or name in self._known_locks):
            return None
        if isinstance(expr, ast.Name):
            return (None, name)
        return (expr.value.id, name)

    def _canonical(self, base: Optional[str], name: str,
                   class_name: Optional[str]) -> str:
        if base is None:
            return self.import_aliases.get(name, f"{self.modname}:{name}")
        if base in ("self", "cls") and class_name:
            return f"{class_name}.{name}"
        return f"~{name}"

    # ---- the concurrency walk -------------------------------------------
    def run_concurrency(self) -> None:
        for line, msg in self.directives.bad:
            self.findings.append(
                Finding("bad-suppression", self.path, line, msg))
        self._walk_body(self.tree.body, held=[], class_name=None,
                        fn_node=None, guard_exempt=True)

    def _walk_body(self, body, held, class_name, fn_node, guard_exempt):
        for stmt in body:
            self._walk_stmt(stmt, held, class_name, fn_node, guard_exempt)

    def _walk_stmt(self, node, held, class_name, fn_node, guard_exempt):
        if isinstance(node, ast.ClassDef):
            # class body executes at import (single-threaded): exempt
            self._walk_body(node.body, [], node.name, None, True)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs LATER: locks lexically held around it
            # are not held when it executes — reset the held set
            seeded: List[_Held] = []
            for lock in self.directives.fn_lock_held(node):
                seeded.append(_Held("self", lock,
                                    self._canonical("self", lock,
                                                    class_name)))
            exempt = (class_name is not None and fn_node is None
                      and node.name == "__init__") \
                or self.directives.fn_is_init(node)
            self._walk_body(node.body, seeded, class_name, node, exempt)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                lk = self._lockish(item.context_expr)
                if lk is None:
                    self._visit_exprs(item.context_expr, held, class_name,
                                      fn_node, guard_exempt)
                    continue
                base, name = lk
                canon = self._canonical(base, name, class_name)
                if held and not self.directives.suppressed(
                        "lock-order", node.lineno):
                    outer = held[-1].canonical
                    if outer != canon:
                        self.lock_edges.setdefault(outer, {}) \
                            .setdefault(canon, (self.path, node.lineno))
                held.append(_Held(base, name, canon))
                pushed += 1
            self._walk_body(node.body, held, class_name, fn_node,
                            guard_exempt)
            for _ in range(pushed):
                held.pop()
            return
        # generic statement: visit expressions, recurse into sub-bodies
        for field in ("test", "iter", "value", "targets", "target", "exc",
                      "cause", "msg", "items", "subject"):
            sub = getattr(node, field, None)
            if sub is None:
                continue
            for expr in (sub if isinstance(sub, list) else [sub]):
                if isinstance(expr, ast.AST):
                    self._visit_exprs(expr, held, class_name, fn_node,
                                      guard_exempt)
        for field in ("body", "orelse", "finalbody", "handlers", "cases"):
            sub = getattr(node, field, None)
            if not sub:
                continue
            for child in sub:
                if isinstance(child, (ast.ExceptHandler, ast.match_case)):
                    self._walk_body(child.body, held, class_name, fn_node,
                                    guard_exempt)
                elif isinstance(child, ast.AST):
                    self._walk_stmt(child, held, class_name, fn_node,
                                    guard_exempt)

    def _visit_exprs(self, expr, held, class_name, fn_node, guard_exempt):
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute):
                self._check_attr_access(node, held, class_name, fn_node,
                                        guard_exempt)
                self._check_plane_state_attr(node)
            elif isinstance(node, ast.Name):
                self._check_global_access(node, held, fn_node, guard_exempt)
            elif isinstance(node, ast.Call):
                self._check_blocking(node, held)
                self._check_thread_spawn(node)
                self._check_plane_state_thread(node)
            elif isinstance(node, (ast.Lambda,)):
                pass        # lambdas run later; their bodies are tiny and
                # attribute checks inside would be against a reset held
                # set — handled conservatively by not descending
                # (ast.walk descends anyway; accesses in lambdas are
                # checked against the ENCLOSING held set, a known
                # imprecision kept for simplicity)

    # ---- pass 1: guarded state -----------------------------------------
    def _check_attr_access(self, node: ast.Attribute, held, class_name,
                           fn_node, guard_exempt) -> None:
        if guard_exempt or class_name is None or fn_node is None:
            return
        guards = self.class_guards.get(class_name)
        if not guards or node.attr not in guards:
            return
        if not isinstance(node.value, ast.Name):
            return
        base = node.value.id
        need = guards[node.attr]
        for h in held:
            # a held module-level lock of the declared name also
            # satisfies (instance state guarded by a registry lock —
            # the health-check pattern)
            if h.name == need and (h.base == base or h.base is None):
                return
        if base == "self":
            if need in self.directives.fn_lock_held(fn_node):
                return
        self._report(
            "guarded-state", node.lineno,
            f"{class_name}.{fn_node.name}: access to {base}.{node.attr} "
            f"outside 'with {base}.{need}:' (declared in _GUARDED_BY)")

    def _check_global_access(self, node: ast.Name, held, fn_node,
                             guard_exempt) -> None:
        if guard_exempt or fn_node is None:
            return
        need = self.global_guards.get(node.id)
        if need is None:
            return
        for h in held:
            if h.base is None and h.name == need:
                return
        if need in self.directives.fn_lock_held(fn_node):
            return
        self._report(
            "guarded-state", node.lineno,
            f"{fn_node.name}: access to module global {node.id} outside "
            f"'with {need}:' (declared in _GUARDED_BY_GLOBALS)")

    # ---- pass 3: blocking under lock -----------------------------------
    def _check_blocking(self, node: ast.Call, held) -> None:
        if not held:
            return
        func = node.func
        name = None
        base = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            name = func.attr
            base = func.value
        if name is None:
            return
        blocking = False
        if name in _BLOCKING_NAMES:
            blocking = True
        elif name in _SUBPROCESS_NAMES and isinstance(base, ast.Name) \
                and base.id == "subprocess":
            blocking = True
        elif name == "join":
            # distinguish thread.join(timeout?) from str.join(iterable):
            # a str/bytes receiver, or a single non-numeric argument,
            # is string joining
            if isinstance(base, ast.Constant) and isinstance(
                    base.value, (str, bytes)):
                blocking = False
            elif len(node.args) == 0 and not node.keywords:
                blocking = True
            elif (len(node.args) == 1 and not node.keywords
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, (int, float))):
                blocking = True
            elif any(kw.arg == "timeout" for kw in node.keywords):
                blocking = True
        large_copy = name in _LARGE_COPY_NAMES
        if not blocking and not large_copy:
            return
        locks = ", ".join(h.name for h in held)
        if large_copy:
            # a block-sized memcpy/compare serializes every other
            # waiter for the copy's duration (the demote residue)
            self._report(
                "blocking-under-lock", node.lineno,
                f"large copy '{name}' while holding {locks} — the "
                f"memcpy serializes the lock's other waiters; move it "
                f"outside or suppress with a reason")
            return
        self._report(
            "blocking-under-lock", node.lineno,
            f"call to blocking '{name}' while holding {locks}")

    # ---- pass 4: thread hygiene ----------------------------------------
    def _check_thread_spawn(self, node: ast.Call) -> None:
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if name != "Thread":
            return
        daemon = None
        for kw in node.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = kw.value.value
        joined = self._thread_provably_joined(node)
        if daemon is not True and not joined:
            # a thread that is synchronously joined may be non-daemon
            # (CLI worker fan-outs); anything else must not block exit
            self._report(
                "thread-hygiene", node.lineno,
                "threading.Thread spawned without daemon=True and not "
                "provably joined — a non-daemon thread blocks "
                "interpreter exit and races static teardown")
        if joined or self.directives.thread_marker(node.lineno):
            return
        self._report(
            "thread-hygiene", node.lineno,
            "thread has no visible quiesce path: no .join() on its "
            "handle in this module and no '# fablint: "
            "thread-quiesced(<how>)' marker")

    def _thread_provably_joined(self, node: ast.Call) -> bool:
        """Some name transitively holding the spawned thread is
        .join()ed somewhere in this module.  Aliases are chased through
        assignments (``t = Thread(...)``, ``self._r = t``, ``r, self._r
        = self._r, None``) and for-loops over a holding list (``for t
        in threads: t.join()``) — a weak but honest lexical proof."""

        def tname(t):
            if isinstance(t, ast.Name):
                return t.id
            if isinstance(t, ast.Attribute):
                return t.attr
            return None

        assigns = self._assigns
        names: Set[str] = set()
        for a in assigns:
            if any(sub is node for sub in ast.walk(a.value)):
                for t in a.targets:
                    n = tname(t)
                    if n:
                        names.add(n)
        if not names:
            return False
        changed = True
        while changed:
            changed = False
            for a in assigns:
                if (len(a.targets) == 1
                        and isinstance(a.targets[0], ast.Tuple)
                        and isinstance(a.value, ast.Tuple)
                        and len(a.targets[0].elts) == len(a.value.elts)):
                    pairs = list(zip(a.targets[0].elts, a.value.elts))
                else:
                    pairs = [(t, a.value) for t in a.targets]
                for t, v in pairs:
                    vn = tname(v) if isinstance(
                        v, (ast.Name, ast.Attribute)) else None
                    tn = tname(t)
                    if vn in names and tn and tn not in names:
                        names.add(tn)
                        changed = True
            for n in self.nodes:
                if isinstance(n, ast.For) and isinstance(n.iter, ast.Name) \
                        and n.iter.id in names \
                        and isinstance(n.target, ast.Name) \
                        and n.target.id not in names:
                    names.add(n.target.id)
                    changed = True
        return any(
            re.search(r"\b%s\s*\.\s*join\s*\(" % re.escape(nm), self.source)
            for nm in names)

    # ---- pass 5: plane-state containment --------------------------------
    def _check_plane_state_attr(self, node: ast.Attribute) -> None:
        if os.path.basename(self.path) == _PLANE_HEALTH_BASENAME:
            return
        if not isinstance(node.ctx, (ast.Store, ast.Del)):
            return
        if not (isinstance(node.value, ast.Name)
                and node.value.id in ("self", "cls")):
            return
        if not _PLANE_STATE_RE.match(node.attr):
            return
        self._report(
            "plane-state", node.lineno,
            f"per-plane health state field '{node.attr}' declared outside "
            f"ici/plane_health.py — register the plane with "
            f"plane_health.register_plane() instead of growing a private "
            f"down/reestablish machine")

    def _check_plane_state_thread(self, node: ast.Call) -> None:
        if os.path.basename(self.path) == _PLANE_HEALTH_BASENAME:
            return
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if name != "Thread":
            return
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            tgt = v.attr if isinstance(v, ast.Attribute) else (
                v.id if isinstance(v, ast.Name) else "")
            if _PLANE_THREAD_RE.search(tgt):
                self._report(
                    "plane-state", node.lineno,
                    f"revival thread (target '{tgt}') spawned outside "
                    f"ici/plane_health.py — the engine owns every plane's "
                    f"revival loop; planes supply only a prober callback")

    # ---- custody passes -------------------------------------------------
    # Rule "custody": per-function, path-sensitive.  Every acquisition
    # (declared acquire call, +1 on a declared refcount field) must
    # reach a matching release, a custody-moved marker, or an owning
    # return on EVERY exit path, including exception edges: a statement
    # that can raise while custody is held must sit under a try whose
    # broad handler or finally releases.  Rule "refcount-balance":
    # every ±1 on a declared field sits under its lock, and every
    # decrement dominates a zero-check that frees.
    #
    # Honest lexical scope (the runtime ledger covers the rest): only
    # statement-level acquire shapes are tracked — bare call, direct
    # assign (incl. tuple / attribute targets), ``return acquire()``,
    # ``if [not] acquire():`` — an acquire nested in a larger
    # expression (an append argument, a comprehension) is treated as
    # escaping into that expression's owner.

    def run_custody(self, registry: _CustodyRegistry,
                    emit_bad: bool = False) -> None:
        if emit_bad:
            for line, msg in self.directives.bad:
                self.findings.append(
                    Finding("bad-suppression", self.path, line, msg))
        self._registry = registry
        self._fields = {
            name for name, decls in registry.by_name.items()
            if any(d["modname"] == self.modname for d in decls)
            and self._field_decls(name)}
        self._acq_scan(self.tree.body, None)
        self._rc_walk(self.tree.body, None, None, [], [], [])

    def _field_decls(self, field: str) -> List[dict]:
        return [d for d in self._registry.by_name.get(field, ())
                if d["modname"] == self.modname]

    # -- acquisition discovery -------------------------------------------
    def _acq_scan(self, body, class_name) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                self._acq_scan(stmt.body, stmt.name)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not self._registry.exempt_fn(self.modname, class_name,
                                                stmt.name):
                    self._fn_check_acquires(stmt, class_name)
                self._acq_scan(stmt.body, class_name)
            else:
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        self._acq_scan(sub, class_name)
                for h in getattr(stmt, "handlers", None) or []:
                    self._acq_scan(h.body, class_name)

    def _fn_check_acquires(self, fn, class_name) -> None:
        found: List[Tuple[list, dict]] = []

        def descend(block, chain):
            for i, stmt in enumerate(block):
                here = chain + [(block, i)]
                acq = self._acquire_in_stmt(stmt, class_name)
                if acq is not None:
                    found.append((here, acq))
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue    # nested defs run later: their own scan
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        descend(sub, here)
                for h in getattr(stmt, "handlers", None) or []:
                    descend(h.body, here)

        descend(fn.body, [])
        for path, acq in found:
            self._flow_token(fn, path, acq)

    def _match_acquire_call(self, call, class_name):
        """(releases, root, name) when ``call`` is a declared acquire
        reached through a matching receiver; None otherwise."""
        if not isinstance(call, ast.Call):
            return None
        f = call.func
        recv = root = None
        if isinstance(f, ast.Name):
            name = f.id
        elif isinstance(f, ast.Attribute):
            name = f.attr
            v = f.value
            if isinstance(v, ast.Name):
                recv = root = v.id
            elif isinstance(v, ast.Attribute) and isinstance(v.value,
                                                             ast.Name):
                recv, root = v.attr, v.value.id
            else:
                return None
        else:
            return None
        if recv is not None and recv not in ("self", "cls") \
                and _LOCKISH_RE.search(recv):
            return None           # cv.acquire()/lock.acquire() etc.
        rels: Set[str] = set()
        hit = False
        for d in self._registry.by_name.get(name, ()):
            if d["class_name"] is None:
                if d["modname"] != self.modname:
                    continue
            elif recv in ("self", "cls"):
                if not (d["modname"] == self.modname
                        and d["class_name"] == class_name):
                    continue
            elif recv is None or not (_name_tokens(recv) & d["tokens"]):
                continue
            hit = True
            rels.update(d["releases"])
        if not hit:
            return None
        return rels, root, name

    def _acquire_in_stmt(self, stmt, class_name):
        """Token dict for a statement-level acquisition, or None.
        ``form``: bare | assign | ifnot | ifheld; ``return``-shaped
        acquires are owning-return satisfied and yield no token."""
        def tok(call, m, form, owners):
            rels, root, name = m
            return {"form": form, "line": call.lineno,
                    "stmt_line": stmt.lineno, "name": name,
                    "releases": rels, "root": root,
                    "owners": owners, "field": None, "stmt": stmt}

        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            m = self._match_acquire_call(stmt.value, class_name)
            if m:
                return tok(stmt.value, m, "bare", set())
        elif isinstance(stmt, ast.Assign) \
                and isinstance(stmt.value, ast.Call):
            m = self._match_acquire_call(stmt.value, class_name)
            if m:
                owners: Set[str] = set()
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        owners.add(t.id)
                    elif isinstance(t, ast.Tuple):
                        owners.update(e.id for e in t.elts
                                      if isinstance(e, ast.Name))
                    elif isinstance(t, ast.Attribute):
                        n = t.value
                        while isinstance(n, ast.Attribute):
                            n = n.value
                        if isinstance(n, ast.Name):
                            owners.add(n.id)   # s.sid = pool.get(): s owns
                return tok(stmt.value, m, "assign", owners)
        elif isinstance(stmt, ast.Return) and stmt.value is not None:
            for n in ast.walk(stmt.value):
                if isinstance(n, ast.Call) \
                        and self._match_acquire_call(n, class_name):
                    return None     # returned to the caller: owner moves
        elif isinstance(stmt, ast.If):
            t = stmt.test
            terms = t.values if isinstance(t, ast.BoolOp) else [t]
            for term in terms:
                if isinstance(term, ast.UnaryOp) \
                        and isinstance(term.op, ast.Not) \
                        and isinstance(term.operand, ast.Call):
                    m = self._match_acquire_call(term.operand, class_name)
                    if m:
                        return tok(term.operand, m, "ifnot", set())
                elif isinstance(term, ast.Call):
                    m = self._match_acquire_call(term, class_name)
                    if m:
                        return tok(term, m, "ifheld", set())
        # refcount increment as an acquisition (rule 1 over fields)
        for site in self._refcount_sites(stmt):
            if site["delta"] > 0:
                rels: Set[str] = set()
                for d in self._field_decls(site["field"]):
                    rels.update(d["releases"])
                return {"form": "bare", "line": site["line"],
                        "stmt_line": stmt.lineno, "name": site["field"],
                        "releases": rels, "root": None, "owners": set(),
                        "field": site["field"], "stmt": stmt}
        return None

    # -- the per-token flow ----------------------------------------------
    def _flow_token(self, fn, path, tok) -> None:
        stmt = tok["stmt"]
        if self.directives.moved_marker(tok["line"], tok["stmt_line"]):
            return                  # explicit ownership transfer
        for ln in (tok["line"], tok["stmt_line"]):
            if self.directives.suppressed("custody", ln):
                return
        self._tok_problem = False
        H, R = True, False
        level = len(path) - 1
        if tok["form"] == "ifheld":
            env = self._env_at(path, level, tok)
            out = self._exec_block(stmt.body, 0, {H}, env, tok)
        else:
            out = {"fall": {H}, "break": set(), "continue": set()}
        while not self._tok_problem:
            block, i = path[level]
            env = self._env_at(path, level, tok)
            nxt = self._exec_block(block, i + 1, out["fall"], env, tok)
            out = {"fall": nxt["fall"],
                   "break": out["break"] | nxt["break"],
                   "continue": out["continue"] | nxt["continue"]}
            if level == 0:
                break
            parent_block, pi = path[level - 1]
            parent = parent_block[pi]
            out = self._apply_container(parent, block, out,
                                        self._env_at(path, level - 1, tok),
                                        tok)
            level -= 1
        if not self._tok_problem and H in out["fall"]:
            self._tok_fail(tok, fn.body[-1].lineno,
                           "function can fall off its end with custody "
                           "still held")

    def _tok_fail(self, tok, line: int, what: str) -> None:
        if self._tok_problem:
            return
        self._tok_problem = True
        rels = ", ".join(sorted(tok["releases"])) or "<none declared>"
        self._report(
            "custody", tok["line"],
            f"'{tok['name']}' acquisition {what} (at/after line {line}) "
            f"— release ({rels}), return the owner, or mark "
            f"'# fablint: custody-moved(<to>) <reason>'")

    def _env_at(self, path, level, tok) -> dict:
        env = {"exc_covered": False, "exit_released": False}
        for j in range(level):
            blk, i = path[j]
            stmt = blk[i]
            if not isinstance(stmt, ast.Try):
                continue
            child = path[j + 1][0]
            fin = self._finally_releases(stmt, tok)
            if child is stmt.body:
                if fin:
                    env["exc_covered"] = env["exit_released"] = True
                if self._try_covers(stmt, tok):
                    env["exc_covered"] = True
            elif fin and (child is stmt.orelse
                          or any(child is h.body for h in stmt.handlers)):
                env["exc_covered"] = env["exit_released"] = True
        return env

    def _apply_container(self, parent, child_block, out, env, tok) -> dict:
        if isinstance(parent, (ast.While, ast.For, ast.AsyncFor)) \
                and child_block is parent.body:
            # loop-back and break both eventually exit the loop; held
            # states survive into the code after it
            return {"fall": out["fall"] | out["break"] | out["continue"],
                    "break": set(), "continue": set()}
        if isinstance(parent, ast.Try):
            if self._finally_releases(parent, tok):
                return {"fall": {False} if (out["fall"] or out["break"]
                                            or out["continue"]) else set(),
                        "break": set(), "continue": set()}
            if parent.finalbody and child_block is not parent.finalbody:
                self._exec_block(parent.finalbody, 0, out["fall"], env, tok)
        return out

    def _exec_block(self, stmts, i0, states, env, tok) -> dict:
        cur = set(states)
        brk: Set[bool] = set()
        cont: Set[bool] = set()
        for s in stmts[i0:]:
            if not cur or cur == {False}:
                break
            o = self._exec_stmt(s, cur, env, tok)
            brk |= o["break"]
            cont |= o["continue"]
            cur = o["fall"]
        return {"fall": cur, "break": brk, "continue": cont}

    def _exec_stmt(self, s, states, env, tok) -> dict:
        H = True
        fall = lambda st: {"fall": set(st), "break": set(),
                           "continue": set()}
        if H not in states:
            return fall(states)
        if isinstance(s, ast.Return):
            if not (self._owner_return(s, tok) or env["exit_released"]
                    or (s.value is not None
                        and self._release_call_in(s.value, tok))
                    or self.directives.moved_marker(s.lineno)):
                self._tok_fail(tok, s.lineno, "returns without releasing")
            return fall(())
        if isinstance(s, ast.Raise):
            if not (env["exc_covered"] or env["exit_released"]
                    or self.directives.moved_marker(s.lineno)):
                self._tok_fail(tok, s.lineno, "raises without releasing")
            return fall(())
        if isinstance(s, ast.Break):
            return {"fall": set(), "break": set(states), "continue": set()}
        if isinstance(s, ast.Continue):
            return {"fall": set(), "break": set(),
                    "continue": set(states)}
        if isinstance(s, ast.If):
            self._edge_check(s.test, env, tok)
            b = self._exec_block(s.body, 0, states, env, tok)
            e = (self._exec_block(s.orelse, 0, states, env, tok)
                 if s.orelse else fall(states))
            return {"fall": b["fall"] | e["fall"],
                    "break": b["break"] | e["break"],
                    "continue": b["continue"] | e["continue"]}
        if isinstance(s, (ast.While, ast.For, ast.AsyncFor)):
            self._edge_check(getattr(s, "test", None)
                             or getattr(s, "iter", None), env, tok)
            b = self._exec_block(s.body, 0, states, env, tok)
            exit_states = (set(states) | b["fall"] | b["continue"]
                           | b["break"])
            if s.orelse:
                o = self._exec_block(s.orelse, 0, exit_states, env, tok)
                exit_states = o["fall"] | b["break"]
            return fall(exit_states)
        if isinstance(s, ast.Try):
            if env["exit_released"] or self._finally_releases(s, tok):
                return fall({False})    # every exit passes the release
            cov = env["exc_covered"] or self._try_covers(s, tok)
            env2 = dict(env, exc_covered=cov)
            b = self._exec_block(s.body, 0, states, env2, tok)
            outs = [b]
            for h in s.handlers:
                outs.append(self._exec_block(h.body, 0, states, env, tok))
            if s.orelse:
                outs.append(self._exec_block(s.orelse, 0, b["fall"],
                                             env, tok))
                outs.remove(b)
                outs.insert(0, {"fall": set(), "break": b["break"],
                                "continue": b["continue"]})
            merged = {
                "fall": set().union(*(o["fall"] for o in outs)),
                "break": set().union(*(o["break"] for o in outs)),
                "continue": set().union(*(o["continue"] for o in outs))}
            if s.finalbody:
                f = self._exec_block(s.finalbody, 0,
                                     merged["fall"] or set(states),
                                     env, tok)
                merged["fall"] = f["fall"] if merged["fall"] else set()
            return merged
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                if self._lockish(item.context_expr) is None:
                    self._edge_check(item.context_expr, env, tok)
            return self._exec_block(s.body, 0, states, env, tok)
        if isinstance(s, ast.Match):
            outs = [self._exec_block(c.body, 0, states, env, tok)
                    for c in s.cases]
            outs.append(fall(states))
            return {
                "fall": set().union(*(o["fall"] for o in outs)),
                "break": set().union(*(o["break"] for o in outs)),
                "continue": set().union(*(o["continue"] for o in outs))}
        # simple statement
        if self._release_call_in(s, tok):
            return fall({False})
        self._edge_check(s, env, tok)
        return fall(states)

    def _edge_check(self, node, env, tok) -> None:
        """A call that can raise while custody is held needs enclosing
        try coverage."""
        if node is None or env["exc_covered"] or env["exit_released"] \
                or self._tok_problem:
            return
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name) and f.id in _BENIGN_CALLS:
                continue
            if isinstance(f, ast.Attribute):
                if f.attr in _BENIGN_METHODS:
                    continue
                r = f.value
                while isinstance(r, ast.Attribute):
                    r = r.value
                if isinstance(r, ast.Name) and r.id in _BENIGN_ROOTS:
                    continue
            self._tok_fail(
                tok, n.lineno,
                "can raise before the release — wrap the region in a "
                "try whose broad handler or finally releases")
            return

    def _owner_return(self, s: ast.Return, tok) -> bool:
        if s.value is None or not tok["owners"]:
            return False
        return any(isinstance(n, ast.Name) and n.id in tok["owners"]
                   for n in ast.walk(s.value))

    def _release_call_in(self, node, tok) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Name):
                    nm, root = f.id, None
                elif isinstance(f, ast.Attribute):
                    nm = f.attr
                    r = f.value
                    while isinstance(r, ast.Attribute):
                        r = r.value
                    root = r.id if isinstance(r, ast.Name) else None
                else:
                    continue
                if nm in tok["releases"] and (
                        tok["root"] is None or root is None
                        or root == tok["root"]
                        or (root in ("self", "cls")
                            and tok["root"] in ("self", "cls"))):
                    return True
            if tok["field"] is not None \
                    and self._is_field_decrement(n, tok["field"]):
                return True
        return False

    def _is_field_decrement(self, n, field: str) -> bool:
        def names_field(expr):
            t = expr
            if isinstance(t, ast.Subscript):
                t = t.value
            return isinstance(t, ast.Attribute) and t.attr == field
        if isinstance(n, ast.AugAssign) and isinstance(n.op, ast.Sub) \
                and isinstance(n.value, ast.Constant) \
                and n.value.value == 1:
            return names_field(n.target)
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub) \
                and isinstance(n.right, ast.Constant) \
                and n.right.value == 1 \
                and isinstance(n.left, ast.Call) \
                and isinstance(n.left.func, ast.Attribute) \
                and n.left.func.attr == "get":
            return names_field(n.left.func.value)
        return False

    def _try_covers(self, t: ast.Try, tok) -> bool:
        """A broad handler that releases covers exception edges."""
        for h in t.handlers:
            broad = h.type is None
            if not broad:
                types = (h.type.elts if isinstance(h.type, ast.Tuple)
                         else [h.type])
                broad = any(
                    (isinstance(x, ast.Name) and x.id in _BROAD_EXC_NAMES)
                    or (isinstance(x, ast.Attribute)
                        and x.attr in _BROAD_EXC_NAMES)
                    for x in types)
            if broad and any(self._release_call_in(s, tok)
                             for s in h.body):
                return True
        return False

    def _finally_releases(self, t: ast.Try, tok) -> bool:
        return any(self._release_call_in(s, tok) for s in t.finalbody)

    # -- refcount-balance -------------------------------------------------
    def _refcount_sites(self, stmt) -> List[dict]:
        if not getattr(self, "_fields", None):
            return []

        def field_of(expr):
            t = expr
            if isinstance(t, ast.Subscript):
                t = t.value
            if isinstance(t, ast.Attribute) and t.attr in self._fields:
                return t.attr
            return None

        out = []
        if isinstance(stmt, ast.AugAssign) \
                and isinstance(stmt.op, (ast.Add, ast.Sub)) \
                and isinstance(stmt.value, ast.Constant) \
                and stmt.value.value == 1:
            f = field_of(stmt.target)
            if f:
                out.append({"field": f, "line": stmt.lineno, "var": None,
                            "form": "aug",
                            "delta": 1 if isinstance(stmt.op, ast.Add)
                            else -1})
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.value, ast.BinOp) \
                and isinstance(stmt.value.op, (ast.Add, ast.Sub)) \
                and isinstance(stmt.value.right, ast.Constant) \
                and stmt.value.right.value == 1 \
                and isinstance(stmt.value.left, ast.Call) \
                and isinstance(stmt.value.left.func, ast.Attribute) \
                and stmt.value.left.func.attr == "get":
            f = field_of(stmt.value.left.func.value)
            if f:
                t = stmt.targets[0]
                out.append({
                    "field": f, "line": stmt.lineno,
                    "var": t.id if isinstance(t, ast.Name) else None,
                    "form": "get",
                    "delta": 1 if isinstance(stmt.value.op, ast.Add)
                    else -1})
        return out

    def _rc_walk(self, body, class_name, fn_node, held, chain,
                 anc_ifs) -> None:
        """Refcount-balance walk: lock context + sibling chain for the
        zero-check dominance scan."""
        for i, stmt in enumerate(body):
            here = chain + [(body, i)]
            if isinstance(stmt, ast.ClassDef):
                self._rc_walk(stmt.body, stmt.name, None, [], [], [])
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                seeded = list(self.directives.fn_lock_held(stmt))
                self._rc_walk(stmt.body, class_name, stmt, seeded, [], [])
                continue
            if fn_node is not None:
                for site in self._refcount_sites(stmt):
                    self._check_refcount_site(site, class_name, fn_node,
                                              held, here, anc_ifs)
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                pushed = 0
                for item in stmt.items:
                    lk = self._lockish(item.context_expr)
                    if lk is not None:
                        held.append(lk[1])
                        pushed += 1
                self._rc_walk(stmt.body, class_name, fn_node, held, here,
                              anc_ifs)
                for _ in range(pushed):
                    held.pop()
                continue
            if isinstance(stmt, ast.If):
                self._rc_walk(stmt.body, class_name, fn_node, held, here,
                              anc_ifs + [stmt])
                self._rc_walk(stmt.orelse, class_name, fn_node, held,
                              here, anc_ifs)
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._rc_walk(sub, class_name, fn_node, held, here,
                                  anc_ifs)
            for h in getattr(stmt, "handlers", None) or []:
                self._rc_walk(h.body, class_name, fn_node, held, here,
                              anc_ifs)

    def _check_refcount_site(self, site, class_name, fn_node, held,
                             chain, anc_ifs) -> None:
        field = site["field"]
        decls = self._field_decls(field)
        # required lock: the field's _GUARDED_BY entry in its declaring
        # class, else any held lock
        need = None
        for d in decls:
            if d["class_name"] and d["class_name"] in self.class_guards:
                need = self.class_guards[d["class_name"]].get(field, need)
        marked = self.directives.fn_lock_held(fn_node)
        if need is not None:
            guarded = need in held or need in marked
        else:
            guarded = bool(held) or bool(marked)
        if not guarded:
            self._report(
                "refcount-balance", site["line"],
                f"±1 on declared refcount field '{field}' outside "
                + (f"'with {need}:'" if need else "any held lock")
                + " — refcount mutations must be serialized")
        if site["delta"] > 0:
            return
        if not self._decrement_zero_checked(site, chain, anc_ifs):
            self._report(
                "refcount-balance", site["line"],
                f"decrement of refcount field '{field}' has no "
                f"dominating zero-check that frees — a count that "
                f"reaches zero silently strands the resource (guard "
                f"with '> 1', or follow with 'if r <= 0: free()')")

    def _decrement_zero_checked(self, site, chain, anc_ifs) -> bool:
        field, var = site["field"], site["var"]
        # shape 1: decrement under an `if F.get(k, d) > 1:` guard —
        # provably never reaches zero
        for iff in anc_ifs:
            for n in ast.walk(iff.test):
                if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                        and isinstance(n.ops[0], (ast.Gt, ast.GtE)) \
                        and isinstance(n.comparators[0], ast.Constant) \
                        and n.comparators[0].value >= 1 \
                        and self._mentions_field(n.left, field):
                    return True
        # shape 2: a later sibling (at any enclosing level) checks the
        # result and frees
        for block, idx in chain:
            for stmt in block[idx + 1:]:
                for n in ast.walk(stmt):
                    if not isinstance(n, ast.If):
                        continue
                    if self._zero_test(n.test, field, var) \
                            and self._frees(n.body):
                        return True
        return False

    def _mentions_field(self, expr, field: str) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Attribute) and n.attr == field:
                return True
        return False

    def _zero_test(self, test, field: str, var) -> bool:
        for n in ast.walk(test):
            if var is not None and isinstance(n, ast.Compare) \
                    and isinstance(n.left, ast.Name) and n.left.id == var \
                    and len(n.ops) == 1 \
                    and isinstance(n.ops[0], (ast.LtE, ast.Lt, ast.Eq)):
                return True
            if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not) \
                    and self._mentions_field(n.operand, field):
                return True
            if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.ops[0], (ast.LtE, ast.Lt, ast.Eq)) \
                    and self._mentions_field(n.left, field):
                return True
        return False

    def _frees(self, body) -> bool:
        for stmt in body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Delete):
                    return True
                if isinstance(n, ast.Call):
                    f = n.func
                    nm = f.attr if isinstance(f, ast.Attribute) else (
                        f.id if isinstance(f, ast.Name) else "")
                    if _FREEISH_RE.search(nm):
                        return True
        return False

    # ---- dead-code passes ----------------------------------------------
    def run_deadcode(self) -> None:
        self._dead_imports()
        self._unreachable()
        self._dead_globals()

    def _used_names(self) -> Set[str]:
        if self._used is None:
            self._used = self._collect_used_names()
        return self._used

    def _collect_used_names(self) -> Set[str]:
        used: Set[str] = set()
        for node in self.nodes:
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                # x.y.z — count the root name (handled by Name Load) and
                # string re-exports via __all__ below
                pass
        for stmt in self.tree.body:
            if (isinstance(stmt, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in stmt.targets)
                    and isinstance(stmt.value, (ast.List, ast.Tuple))):
                for elt in stmt.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                            elt.value, str):
                        used.add(elt.value)
        return used

    def _dead_imports(self) -> None:
        if os.path.basename(self.path) == "__init__.py":
            return              # re-export modules: imports ARE the API
        used = self._used_names()
        for node in self.nodes:
            aliases = []
            if isinstance(node, ast.Import):
                aliases = node.names
            elif isinstance(node, ast.ImportFrom):
                aliases = node.names
            if isinstance(node, ast.ImportFrom) \
                    and node.module == "__future__":
                continue
            for alias in aliases:
                if alias.name == "*":
                    continue
                bound = alias.asname or alias.name.split(".")[0]
                if bound in used:
                    continue
                if node.lineno in self.directives.noqa:
                    continue
                self._report("dead-import", node.lineno,
                             f"'{bound}' imported but never used")

    def _unreachable(self) -> None:
        for node in self.nodes:
            for field in ("body", "orelse", "finalbody"):
                body = getattr(node, field, None)
                if not isinstance(body, list):
                    continue
                terminated = False
                for stmt in body:
                    if terminated:
                        self._report("unreachable", stmt.lineno,
                                     "statement is unreachable (follows "
                                     "return/raise/break/continue)")
                        break
                    if isinstance(stmt, (ast.Return, ast.Raise, ast.Break,
                                         ast.Continue)):
                        terminated = True
            if isinstance(node, (ast.If, ast.While)) and isinstance(
                    node.test, ast.Constant) and node.test.value is False:
                self._report("unreachable", node.lineno,
                             "branch condition is literally False")

    def _dead_globals(self) -> None:
        used = self._used_names()
        stores: Dict[str, int] = {}
        for stmt in self.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                targets = [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    stores.setdefault(t.id, stmt.lineno)
        for name, line in sorted(stores.items(), key=lambda kv: kv[1]):
            if not name.startswith("_") or name.startswith("__"):
                continue        # public names may be imported elsewhere
            if name in used or name in ("_GUARDED_BY_GLOBALS",
                                        "_CUSTODY"):
                continue
            if line in self.directives.noqa:
                continue
            self._report("dead-global", line,
                         f"module-level private name '{name}' is written "
                         f"but never read in this module")


# ---- entry points -------------------------------------------------------

def _iter_py_files(paths: List[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                for f in sorted(files):
                    if f.endswith(".py") and not f.endswith("_pb2.py"):
                        out.append(os.path.join(root, f))   # _pb2: generated
        elif p.endswith(".py"):
            out.append(p)
    return out


def _modname_for(path: str) -> str:
    """Dotted module name: walk up while __init__.py exists."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    name = ".".join(reversed(parts))
    return name[:-len(".__init__")] if name.endswith(".__init__") else name


def _find_cycles(graph: Dict[str, Dict[str, Tuple[str, int]]]
                 ) -> List[List[str]]:
    """Cycles in the acquisition digraph (one representative per SCC
    with a cycle), via iterative Tarjan."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(v0: str) -> None:
        work = [(v0, iter(graph.get(v0, ())))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on_stack.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(graph.get(w, ()))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1 or v in graph.get(v, ()):
                    sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def run(paths: List[str], rules: Tuple[str, ...]) -> List[Finding]:
    findings: List[Finding] = []
    edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
    want_conc = any(r in rules for r in CONCURRENCY_RULES)
    want_dead = any(r in rules for r in DEADCODE_RULES)
    want_cust = any(r in rules for r in CUSTODY_RULES)
    # phase 1: parse everything — custody declarations are cross-file
    # (``pool.pin`` in migration.py resolves against kv_pool's map)
    lints: List[ModuleLint] = []
    registry = _CustodyRegistry()
    for path in _iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            lint = ModuleLint(path, source, _modname_for(path))
        except SyntaxError as e:
            findings.append(Finding("parse-error", path, e.lineno or 0,
                                    str(e)))
            continue
        lints.append(lint)
        if want_cust:
            for class_name, cmap in lint.custody_decls:
                registry.add(lint.modname, class_name, cmap)
    # phase 2: analyze
    for lint in lints:
        if want_conc:
            lint.run_concurrency()
        if want_cust:
            lint.run_custody(registry, emit_bad=not want_conc)
        if want_dead:
            lint.run_deadcode()
        findings.extend(f for f in lint.findings if f.rule in rules
                        or f.rule == "parse-error")
        for src, dsts in lint.lock_edges.items():
            for dst, loc in dsts.items():
                edges.setdefault(src, {}).setdefault(dst, loc)
    if "lock-order" in rules:
        for comp in _find_cycles(edges):
            locs = []
            for a in comp:
                for b, (p, ln) in edges.get(a, {}).items():
                    if b in comp:
                        locs.append(f"{a} -> {b} at {p}:{ln}")
            first = edges[comp[0]]
            path0, line0 = next(iter(first.values()))
            findings.append(Finding(
                "lock-order", path0, line0,
                "lock acquisition cycle: " + "; ".join(sorted(locs))))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lock_order_edges(paths: List[str]
                     ) -> Dict[str, Dict[str, Tuple[str, int]]]:
    """The extracted acquisition graph (docs/CONCURRENCY.md generator)."""
    edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
    for path in _iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            lint = ModuleLint(path, source, _modname_for(path))
        except SyntaxError:
            continue
        lint.run_concurrency()
        for src, dsts in lint.lock_edges.items():
            for dst, loc in dsts.items():
                edges.setdefault(src, {}).setdefault(dst, loc)
    return edges


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    only: Optional[Tuple[str, ...]] = None
    out: List[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "--rules":
            if i + 1 >= len(argv):
                print("fablint: --rules needs a comma-separated list",
                      file=sys.stderr)
                return 2
            only = tuple(r.strip() for r in argv[i + 1].split(",")
                         if r.strip())
            i += 2
        elif argv[i].startswith("--rules="):
            only = tuple(r.strip()
                         for r in argv[i].split("=", 1)[1].split(",")
                         if r.strip())
            i += 1
        else:
            out.append(argv[i])
            i += 1
    argv = out
    cmd = "check"
    if argv and argv[0] in ("check", "deadcode", "custody", "all"):
        cmd = argv.pop(0)
    paths = argv or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    rules = {"check": CONCURRENCY_RULES,
             "deadcode": DEADCODE_RULES,
             "custody": CUSTODY_RULES + ("bad-suppression",),
             "all": ALL_RULES}[cmd]
    if only is not None:
        bad = [r for r in only if r not in ALL_RULES]
        if bad:
            print(f"fablint: unknown rule(s) {', '.join(bad)} — "
                  f"choose from {', '.join(ALL_RULES)}",
                  file=sys.stderr)
            return 2
        rules = tuple(r for r in rules if r in only) or only
    findings = run(paths, rules)
    if as_json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
        print(f"fablint: {len(findings)} finding(s) "
              f"[{cmd}] over {len(_iter_py_files(paths))} file(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
