"""`torchcheck` host-side concurrency tier: lock-discipline static
analysis (JC101-JC103) over the fleet's concurrent systems code.

Layer 1 (lint.py) guards the device path; this layer guards the *host*
surface around it — the staged round pipeline, the multi-worker pool,
the TCP wire dispatcher, the router tier. Their correctness rests on a
locking protocol written down as ``# guarded-by`` comments and the
`utils.locks` ranks. The rules:

- **JC101 guarded-field-access-outside-lock** — an attribute declared
  with a ``# guarded-by: <lockname>`` trailing comment (on its
  ``self.x = ...`` line in ``__init__`` or its class-level annotation)
  is read or written in a method body without that lock held, either
  lexically (``with self._lock:`` / ``.acquire()`` scope) or by
  *entry contract* (every call site of the enclosing helper holds the
  lock — computed as an intersection over the call graph). Unannotated
  fields are *inferred* guarded when they have >= 5 accesses, >= 80%
  of them under one lock, and at least one unlocked WRITE — only the
  unlocked writes are reported (reads of a mostly-guarded field are a
  weaker signal and stay quiet).
- **JC102 lock-order-cycle** — the static lock-nesting graph (edges
  ``A -> B`` wherever ``B`` is acquired with ``A`` held, propagated
  through the call graph via each function's transitive acquire set)
  contains a cycle. Every edge participating in a cycle is reported at
  its acquisition site; any interleaving of the two paths deadlocks.
- **JC103 blocking-call-under-service-lock** — a blocking primitive
  (socket ``sendall``/``recv``/``accept``/``connect``, ``sleep``,
  thread/process ``join``, ``Event.wait``, ``os.fsync``, pipe
  ``send_bytes``/``recv_bytes``, future/ticket ``result``, and the
  port's device reads: ``torch.cuda.synchronize``, a CUDA event's or
  stream's ``.synchronize()``, ``.item``/``.tolist``/``.cpu``/
  ``.numpy`` on a tensor) executes while a *service-tier* lock is held
  (a lock whose `OrderedLock` family starts with ``serve.`` or that is
  declared in `aclswarm_torch.serve`). One slow client, or one read
  that waits for the card's queue, inside such a window parks every
  thread queued on that lock. Propagates through the call graph: a
  helper that fsyncs is reported at the locked *call site* (unless the
  helper is itself entry-held, in which case the primitive site
  reports — exactly one report per chain). ``cv.wait()`` on a
  condition you hold is the intended CV pattern and never reports
  *that* lock (other held locks still do).

Held-set model: flow-insensitive within a body, lexical ``with``
scoping plus linear ``.acquire()``/``.release()`` tracking per block,
entry-held sets via a greatest-fixpoint intersection over call sites
(a helper counts as lock-held only when EVERY caller holds the lock).
Receiver types for cross-object locks (``svc._lock``, ``pool._lock``)
come from parameter annotations and ``self.x = ClassName(...)``
constructor scans — annotate the protocol to make it checkable.

Escape hatch: the standard torchcheck pragmas (``# torchcheck:
disable=JC103 <reason>`` per line, ``# torchcheck: disable-file=...``
per file); every suppression in-tree names the invariant that makes it
safe.

Run standalone: ``python -m aclswarm_torch.analysis.concurrency`` (or
``python -m aclswarm_torch.analysis.lint --concurrency``); default paths
are the four host-side dirs. Exit 1 on any violation.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import re
import sys
from pathlib import Path

from .lint import (FuncInfo, Linter, ModuleInfo, Violation,  # noqa: F401
                   _dotted)

RULES = {
    "JC101": "guarded field accessed outside its lock",
    "JC102": "lock-order cycle",
    "JC103": "blocking call while holding a service lock",
}

# lock constructors (fq after alias resolution; Ordered* matched by
# suffix so fixtures may import them from anywhere)
_LOCK_CTOR_FQ = {"threading.Lock", "threading.RLock", "threading.Condition"}
_LOCK_CTOR_SUFFIXES = (".OrderedLock", ".OrderedRLock")

# JC103 blocking primitives: exact fq names ...
_BLOCKING_FQ = {
    "time.sleep", "select.select", "os.fsync",
    "torch.cuda.synchronize", "socket.create_connection",
}
# ... and method names on unresolved receivers (sockets, threads,
# events, pipes, futures, a CUDA event or stream's `.synchronize`, a
# tensor's device reads). `.join` on a string literal is excluded;
# `.wait` on a lock/condition the caller holds reports only the OTHER
# held locks (the CV protocol releases the waited-on lock).
_BLOCKING_METHODS = {
    "sendall", "sendto", "recv", "recv_into", "recvfrom", "accept",
    "connect", "join", "wait", "fsync", "sleep", "select",
    "synchronize", "item", "tolist", "cpu", "numpy", "send_bytes",
    "recv_bytes", "result",
}

# stdlib queue constructors: a local built from one of these is a
# blocking channel, and `.get()` / `.get(timeout=...)` on it parks the
# calling thread. Bare "get" can NOT live in _BLOCKING_METHODS (every
# dict read would match), so queue receivers are typed explicitly and
# checked by receiver type instead.
_QUEUE_CTOR_FQ = {
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
    "queue.SimpleQueue",
}
_STDLIB_QUEUE = "<stdlib>.queue.Queue"     # pseudo-classkey (never a
#                                            repo class: see _by_fq)

# mutating method names that count as WRITES of `self.attr` for the
# guarded-by inference (``self._jobs.pop(rid)`` mutates `_jobs`)
_MUTATORS = {
    "append", "appendleft", "add", "clear", "discard", "extend",
    "insert", "pop", "popleft", "popitem", "remove", "setdefault",
    "update",
}

# methods whose body is construction-time (fields may be written
# before the object is shared across threads)
_CTOR_METHODS = {"__init__", "__post_init__", "__new__"}

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")

_SERVICE_MODULE_PREFIX = "aclswarm_torch.serve"
_SERVICE_FAMILY_PREFIX = "serve."


def _short(lockid: str) -> str:
    return lockid[len("aclswarm_torch."):] if \
        lockid.startswith("aclswarm_torch.") else lockid


@dataclasses.dataclass
class LockDecl:
    lockid: str                 # "mod.Class.attr" or "mod.NAME"
    module: ModuleInfo
    attr: str
    line: int
    family: str | None = None   # OrderedLock family literal, if any
    service_tier: bool = False


@dataclasses.dataclass
class ClassInfo:
    key: str                    # "mod:Qualname"
    module: ModuleInfo
    qual: str                   # possibly dotted for nested classes
    node: ast.ClassDef
    locks: dict[str, LockDecl] = dataclasses.field(default_factory=dict)
    # attr -> (lockname-as-written, line of the annotation)
    guarded_raw: dict[str, tuple[str, int]] = \
        dataclasses.field(default_factory=dict)
    guard: dict[str, str] = dataclasses.field(default_factory=dict)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    methods: dict[str, FuncInfo] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Facts:
    """Per-function lock facts from one flow-insensitive body scan."""

    info: FuncInfo
    clskey: str | None
    is_ctor: bool
    # (lockid, held-before tuple, site node)
    acquires: list[tuple] = dataclasses.field(default_factory=list)
    # (call node, callee facts-key | None, held frozenset)
    calls: list[tuple] = dataclasses.field(default_factory=list)
    # (attr, held frozenset, node, is_write)
    accesses: list[tuple] = dataclasses.field(default_factory=list)
    # (description, held frozenset, node, excluded lockid | None)
    blocking: list[tuple] = dataclasses.field(default_factory=list)


_TOP = None     # entry-held lattice top (= "all locks", ∩-identity)


class ConcurrencyChecker(Linter):
    """JC101-JC103 over the host-side concurrent modules.

    Reuses the torchcheck Linter's module loading, alias maps, pragma
    bookkeeping and import-aware call resolution; adds lock/guard
    collection, held-set scanning and the three rule passes.
    """

    def __init__(self) -> None:
        super().__init__()
        self.classes: dict[str, ClassInfo] = {}
        self._by_name: dict[str, list[str]] = {}     # bare name -> keys
        self._by_fq: dict[str, str] = {}             # mod.Qual -> key
        self.module_locks: dict[str, dict[str, LockDecl]] = {}
        self.locks: dict[str, LockDecl] = {}         # lockid -> decl
        self.facts: dict[int, _Facts] = {}           # id(FuncInfo) -> facts
        self.entry: dict[int, frozenset | None] = {}
        self._fq_index: dict[str, FuncInfo] = {}

    # -- loading ------------------------------------------------------------
    def load(self, paths: list[Path]) -> None:
        super().load(paths)
        self.src: dict[str, list[str]] = {
            mod.name: mod.path.read_text().splitlines()
            for mod in self.modules.values()}

    # -- lock/guard/type collection ----------------------------------------
    def _is_lock_ctor(self, mod: ModuleInfo, call: ast.Call,
                      scope: FuncInfo | None) -> str | bool | None:
        """OrderedLock family string, True for a plain ctor, else None."""
        fq = self._call_fq(mod, call, scope)
        if fq is None:
            return None
        if fq in _LOCK_CTOR_FQ:
            return True
        if fq.endswith(_LOCK_CTOR_SUFFIXES) or fq in ("OrderedLock",
                                                      "OrderedRLock"):
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                return call.args[0].value
            for k in call.keywords:
                if k.arg == "family" and isinstance(k.value, ast.Constant):
                    return str(k.value.value)
            return True
        return None

    def _collect(self) -> None:
        for mod in self.modules.values():
            self._collect_classes(mod)
            self._collect_module_locks(mod)
        for ci in self.classes.values():
            self._collect_class_body(ci)
        self._resolve_guards()

    def _collect_classes(self, mod: ModuleInfo) -> None:
        def walk(node: ast.AST, qual: list[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    q = qual + [child.name]
                    key = f"{mod.name}:{'.'.join(q)}"
                    ci = ClassInfo(key=key, module=mod,
                                   qual=".".join(q), node=child)
                    for m in ast.iter_child_nodes(child):
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                            info = mod.defs.get(
                                ".".join(q + [m.name]))
                            if info is not None:
                                ci.methods[m.name] = info
                    self.classes[key] = ci
                    self._by_name.setdefault(child.name, []).append(key)
                    self._by_fq[f"{mod.name}.{'.'.join(q)}"] = key
                    walk(child, q)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    continue        # no classes inside functions
        walk(mod.tree, [])

    def _collect_module_locks(self, mod: ModuleInfo) -> None:
        table: dict[str, LockDecl] = {}
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Call):
                fam = self._is_lock_ctor(mod, stmt.value, None)
                if fam is None:
                    continue
                name = stmt.targets[0].id
                decl = LockDecl(
                    lockid=f"{mod.name}.{name}", module=mod, attr=name,
                    line=stmt.lineno,
                    family=fam if isinstance(fam, str) else None)
                decl.service_tier = self._service_tier(decl)
                table[name] = decl
                self.locks[decl.lockid] = decl
        self.module_locks[mod.name] = table

    @staticmethod
    def _service_tier(decl: LockDecl) -> bool:
        if decl.family and decl.family.startswith(_SERVICE_FAMILY_PREFIX):
            return True
        return decl.module.name.startswith(_SERVICE_MODULE_PREFIX)

    def _guard_comment(self, mod: ModuleInfo,
                       node: ast.stmt) -> tuple[str, int] | None:
        lines = self.src.get(mod.name, [])
        for ln in (node.lineno, node.end_lineno or node.lineno):
            if 0 < ln <= len(lines):
                m = _GUARDED_RE.search(lines[ln - 1])
                if m:
                    return m.group(1), ln
        return None

    def _collect_class_body(self, ci: ClassInfo) -> None:
        mod = ci.module
        # class-level annotated fields (dataclass-style declarations)
        for stmt in ci.node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                g = self._guard_comment(mod, stmt)
                if g:
                    ci.guarded_raw[stmt.target.id] = g
                t = self._ann_classkey(stmt.annotation, mod)
                if t:
                    ci.attr_types[stmt.target.id] = t
        # `self.x = ...` declarations across all methods
        for mname, info in ci.methods.items():
            params = self._annotated_params(info, mod)
            for node in self._iter_own_body(info):
                if isinstance(node, ast.AnnAssign) \
                        and self._self_attr(node.target):
                    attr = node.target.attr
                    g = self._guard_comment(mod, node)
                    if g:
                        ci.guarded_raw.setdefault(attr, g)
                    t = self._ann_classkey(node.annotation, mod)
                    if t:
                        ci.attr_types.setdefault(attr, t)
                    if node.value is not None:
                        self._classify_decl(ci, info, params, attr,
                                            node.value, node)
                if not isinstance(node, ast.Assign):
                    continue
                if len(node.targets) != 1 \
                        or not self._self_attr(node.targets[0]):
                    continue
                attr = node.targets[0].attr
                g = self._guard_comment(mod, node)
                if g:
                    ci.guarded_raw.setdefault(attr, g)
                self._classify_decl(ci, info, params, attr,
                                    node.value, node)

    def _classify_decl(self, ci: ClassInfo, info: FuncInfo,
                       params: dict[str, str], attr: str,
                       value: ast.AST, node: ast.stmt) -> None:
        mod = ci.module
        if isinstance(value, ast.Call):
            fam = self._is_lock_ctor(mod, value, info)
            if fam is not None:
                if attr not in ci.locks:
                    decl = LockDecl(
                        lockid=f"{mod.name}.{ci.qual}.{attr}",
                        module=mod, attr=attr, line=node.lineno,
                        family=fam if isinstance(fam, str) else None)
                    decl.service_tier = self._service_tier(decl)
                    ci.locks[attr] = decl
                    self.locks[decl.lockid] = decl
                return
            t = self._class_from_call(mod, value, info)
            if t:
                ci.attr_types.setdefault(attr, t)
        elif isinstance(value, ast.Name) and value.id in params:
            ci.attr_types.setdefault(attr, params[value.id])

    @staticmethod
    def _self_attr(node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self")

    # -- type lookup helpers ------------------------------------------------
    def _classkey_for_name(self, name: str,
                           mod: ModuleInfo) -> str | None:
        # same-module class first, then unique bare name repo-wide
        key = self._by_fq.get(f"{mod.name}.{name}")
        if key:
            return key
        fq = mod.aliases.get(name)
        if fq and fq in self._by_fq:
            return self._by_fq[fq]
        cands = self._by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def _ann_classkey(self, ann: ast.AST | None,
                      mod: ModuleInfo) -> str | None:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            for tok in re.findall(r"[A-Za-z_][A-Za-z0-9_.]*",
                                  ann.value):
                if tok in ("None", "Optional", "Union"):
                    continue
                key = self._classkey_for_name(tok.split(".")[-1], mod)
                if key:
                    return key
            return None
        if isinstance(ann, (ast.Name, ast.Attribute)):
            parts = _dotted(ann)
            return self._classkey_for_name(parts[-1], mod) if parts \
                else None
        if isinstance(ann, ast.Subscript):      # Optional[X] / list[X]
            return self._ann_classkey(ann.slice, mod)
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return (self._ann_classkey(ann.left, mod)
                    or self._ann_classkey(ann.right, mod))
        return None

    def _class_from_call(self, mod: ModuleInfo, call: ast.Call,
                         scope: FuncInfo | None) -> str | None:
        parts = _dotted(call.func)
        if not parts:
            return None
        return self._classkey_for_name(parts[-1], mod)

    def _annotated_params(self, info: FuncInfo,
                          mod: ModuleInfo) -> dict[str, str]:
        out: dict[str, str] = {}
        node = info.node
        if isinstance(node, ast.Lambda):
            return out
        args = node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            t = self._ann_classkey(a.annotation, mod)
            if t:
                out[a.arg] = t
        return out

    # -- per-function scan --------------------------------------------------
    def _clskey_of(self, info: FuncInfo) -> str | None:
        """Enclosing class (closures inside methods share its `self`)."""
        qual = info.fq[len(info.module.name) + 1:]
        parts = qual.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            key = self._by_fq.get(
                f"{info.module.name}.{'.'.join(parts[:cut])}")
            if key:
                return key
        return None

    def _local_types(self, info: FuncInfo,
                     clskey: str | None) -> dict[str, str]:
        mod = info.module
        types = dict(self._annotated_params(info, mod))
        ci = self.classes.get(clskey) if clskey else None
        for node in self._iter_own_body(info):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name):
                continue
            name = node.targets[0].id
            if isinstance(node.value, ast.Call):
                t = self._class_from_call(mod, node.value, info)
                if t:
                    types.setdefault(name, t)
                elif self._call_fq(mod, node.value, info) \
                        in _QUEUE_CTOR_FQ:
                    types.setdefault(name, _STDLIB_QUEUE)
            elif self._self_attr(node.value) and ci is not None:
                t = ci.attr_types.get(node.value.attr)
                if t:
                    types.setdefault(name, t)
        return types

    def _blocking_aliases(self, info: FuncInfo, clskey: str | None,
                          types: dict[str, str]
                          ) -> dict[str, tuple[str, str | None]]:
        """Local names bound to a blocking callable WITHOUT calling it
        (`w = ev.wait`, `f = os.fsync`): the later bare `w(1.0)` /
        `f(fd)` call sites carry no attribute to match, so the binding
        site is where the blocking identity is learned. Maps
        name -> (description, excluded-lockid) with the same cv.wait
        exclusion as the direct-attribute matcher."""
        mod = info.module
        out: dict[str, tuple[str, str | None]] = {}
        assigns = [node for node in self._iter_own_body(info)
                   if isinstance(node, ast.Assign)
                   and len(node.targets) == 1
                   and isinstance(node.targets[0], ast.Name)]
        # _iter_own_body is a LIFO walk: re-establish source order so a
        # later rebind of the name clears the earlier blocking binding
        for node in sorted(assigns, key=lambda n: n.lineno):
            name = node.targets[0].id
            if isinstance(node.value, ast.Call):
                out.pop(name, None)     # rebound to a call result
                continue
            parts = _dotted(node.value)
            if not parts:
                out.pop(name, None)
                continue
            fq = self._resolve(mod, parts, info)
            if isinstance(fq, str) and fq in _BLOCKING_FQ:
                out[name] = (fq, None)
                continue
            if len(parts) >= 2 and parts[-1] in _BLOCKING_METHODS \
                    and isinstance(node.value, ast.Attribute):
                excl = None
                if parts[-1] == "wait":
                    # aliased cv.wait still releases cv when called
                    excl = self._lock_node(node.value.value, mod,
                                           clskey, types)
                out[name] = (f".{parts[-1]}()", excl)
                continue
            out.pop(name, None)
        return out

    def _lock_node(self, expr: ast.AST, mod: ModuleInfo,
                   clskey: str | None,
                   types: dict[str, str]) -> str | None:
        parts = _dotted(expr)
        if not parts:
            return None
        ci = self.classes.get(clskey) if clskey else None
        if parts[0] == "self" and ci is not None:
            if len(parts) == 2 and parts[1] in ci.locks:
                return ci.locks[parts[1]].lockid
            if len(parts) == 3:
                tkey = ci.attr_types.get(parts[1])
                tci = self.classes.get(tkey) if tkey else None
                if tci and parts[2] in tci.locks:
                    return tci.locks[parts[2]].lockid
            return None
        if len(parts) == 2:
            tkey = types.get(parts[0])
            tci = self.classes.get(tkey) if tkey else None
            if tci and parts[1] in tci.locks:
                return tci.locks[parts[1]].lockid
            # other_module.NAME
            fq = mod.aliases.get(parts[0])
            if fq and fq in self.module_locks \
                    and parts[1] in self.module_locks[fq]:
                return self.module_locks[fq][parts[1]].lockid
        if len(parts) == 1:
            decl = self.module_locks.get(mod.name, {}).get(parts[0])
            if decl:
                return decl.lockid
            fq = mod.aliases.get(parts[0])
            if fq:      # from mod import SOME_LOCK
                head, _, leaf = fq.rpartition(".")
                decl = self.module_locks.get(head, {}).get(leaf)
                if decl:
                    return decl.lockid
        return None

    def _resolve_callee(self, call: ast.Call, facts: _Facts,
                        types: dict[str, str]) -> int | None:
        parts = _dotted(call.func)
        if not parts:
            return None
        mod = facts.info.module
        ci = self.classes.get(facts.clskey) if facts.clskey else None
        # typed receivers first (exact), then the Linter fallback
        if ci is not None and parts[0] == "self":
            if len(parts) == 2 and parts[1] in ci.methods:
                return self._fid(ci.methods[parts[1]])
            if len(parts) == 3:
                tci = self.classes.get(ci.attr_types.get(parts[1], ""))
                if tci and parts[2] in tci.methods:
                    return self._fid(tci.methods[parts[2]])
        if len(parts) == 2 and parts[0] in types:
            tci = self.classes.get(types[parts[0]])
            if tci and parts[1] in tci.methods:
                return self._fid(tci.methods[parts[1]])
        t = self._resolve(mod, parts, facts.info)
        if isinstance(t, FuncInfo):
            return self._fid(t)
        return None

    def _fid(self, info: FuncInfo) -> int | None:
        return id(info) if id(info) in self.facts else None

    def _scan_functions(self) -> None:
        for mod in self.modules.values():
            for info in mod.funcs:
                clskey = self._clskey_of(info)
                leaf = info.fq.rsplit(".", 1)[-1]
                self.facts[id(info)] = _Facts(
                    info=info, clskey=clskey,
                    is_ctor=leaf in _CTOR_METHODS)
        for facts in self.facts.values():
            self._scan_one(facts)

    def _scan_one(self, facts: _Facts) -> None:
        info = facts.info
        if isinstance(info.node, ast.Lambda):
            return
        types = self._local_types(info, facts.clskey)
        aliases = self._blocking_aliases(info, facts.clskey, types)
        lock_attrs = set()
        ci = self.classes.get(facts.clskey) if facts.clskey else None
        if ci is not None:
            lock_attrs = set(ci.locks)
        mod = info.module

        def walk_expr(node: ast.AST, held: tuple) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return          # separate FuncInfo, scanned on its own
            if isinstance(node, ast.Call):
                callee = self._resolve_callee(node, facts, types)
                func = node.func
                if callee is not None:
                    facts.calls.append((node, callee, frozenset(held)))
                else:
                    self._check_blocking(node, facts, held, mod,
                                         facts.clskey, types, aliases)
                    if isinstance(func, ast.Attribute) \
                            and func.attr in _MUTATORS \
                            and self._self_attr(func.value) \
                            and func.value.attr not in lock_attrs:
                        facts.accesses.append(
                            (func.value.attr, frozenset(held),
                             func.value, True))
                        for a in list(node.args) \
                                + [k.value for k in node.keywords]:
                            walk_expr(a, held)
                        return
                if isinstance(func, ast.Attribute):
                    walk_expr(func.value, held)
                for a in list(node.args) \
                        + [k.value for k in node.keywords]:
                    walk_expr(a, held)
                return
            if isinstance(node, ast.Attribute) \
                    and self._self_attr(node):
                if node.attr not in lock_attrs:
                    facts.accesses.append(
                        (node.attr, frozenset(held), node,
                         isinstance(node.ctx, (ast.Store, ast.Del))))
                return
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)) \
                    and self._self_attr(node.value) \
                    and node.value.attr not in lock_attrs:
                # self.x[k] = v mutates x: a write for inference
                facts.accesses.append(
                    (node.value.attr, frozenset(held), node.value, True))
                walk_expr(node.slice, held)
                return
            for child in ast.iter_child_nodes(node):
                walk_expr(child, held)

        def scan_block(stmts: list, held: list) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    inner = list(held)
                    for item in stmt.items:
                        lid = self._lock_node(item.context_expr, mod,
                                              facts.clskey, types)
                        if lid is not None:
                            facts.acquires.append(
                                (lid, tuple(inner), item.context_expr))
                            inner.append(lid)
                        else:
                            walk_expr(item.context_expr, tuple(inner))
                        if item.optional_vars is not None:
                            walk_expr(item.optional_vars, tuple(inner))
                    scan_block(stmt.body, inner)
                    continue
                # linear lock.acquire() / lock.release() statements
                acq = self._acquire_stmt(stmt, mod, facts.clskey, types)
                if acq is not None:
                    lid, is_acquire, call = acq
                    if is_acquire:
                        facts.acquires.append((lid, tuple(held), call))
                        held.append(lid)
                    elif lid in held:
                        held.remove(lid)
                    for a in list(call.args) \
                            + [k.value for k in call.keywords]:
                        walk_expr(a, tuple(held))
                    continue
                if isinstance(stmt, ast.If):
                    walk_expr(stmt.test, tuple(held))
                    scan_block(stmt.body, list(held))
                    scan_block(stmt.orelse, list(held))
                elif isinstance(stmt, ast.While):
                    walk_expr(stmt.test, tuple(held))
                    scan_block(stmt.body, list(held))
                    scan_block(stmt.orelse, list(held))
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    walk_expr(stmt.target, tuple(held))
                    walk_expr(stmt.iter, tuple(held))
                    scan_block(stmt.body, list(held))
                    scan_block(stmt.orelse, list(held))
                elif isinstance(stmt, ast.Try):
                    scan_block(stmt.body, list(held))
                    for h in stmt.handlers:
                        scan_block(h.body, list(held))
                    scan_block(stmt.orelse, list(held))
                    scan_block(stmt.finalbody, list(held))
                elif isinstance(stmt, ast.Match):
                    walk_expr(stmt.subject, tuple(held))
                    for case in stmt.cases:
                        scan_block(case.body, list(held))
                else:
                    walk_expr(stmt, tuple(held))

        scan_block(list(info.node.body), [])

    def _acquire_stmt(self, stmt: ast.stmt, mod: ModuleInfo,
                      clskey: str | None, types: dict[str, str]):
        """(lockid, is_acquire, call) for `x.acquire()` / `x.release()`
        statements (bare Expr or `ok = x.acquire(...)`), else None."""
        value = None
        if isinstance(stmt, ast.Expr):
            value = stmt.value
        elif isinstance(stmt, ast.Assign):
            value = stmt.value
        if not (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in ("acquire", "release")):
            return None
        lid = self._lock_node(value.func.value, mod, clskey, types)
        if lid is None:
            return None
        return lid, value.func.attr == "acquire", value

    def _check_blocking(self, call: ast.Call, facts: _Facts,
                        held: tuple, mod: ModuleInfo,
                        clskey: str | None, types: dict[str, str],
                        aliases: dict[str, tuple[str, str | None]]
                        ) -> None:
        fq = self._call_fq(mod, call, facts.info)
        if isinstance(fq, str) and fq in _BLOCKING_FQ:
            facts.blocking.append(
                (fq, frozenset(held), call, None))
            return
        func = call.func
        if isinstance(func, ast.Name) and func.id in aliases:
            desc, excl = aliases[func.id]
            facts.blocking.append(
                (desc, frozenset(held), call, excl))
            return
        if isinstance(func, ast.Attribute) and func.attr == "get" \
                and self._queue_get(func, facts, types) \
                and not self._nonblocking_get(call):
            facts.blocking.append(
                (".get()", frozenset(held), call, None))
            return
        if not isinstance(func, ast.Attribute) \
                or func.attr not in _BLOCKING_METHODS:
            return
        if isinstance(func.value, ast.Constant):
            return      # ", ".join(...) and friends
        excl = None
        if func.attr == "wait":
            # cv.wait() releases cv: never report the waited-on lock
            excl = self._lock_node(func.value, mod, clskey, types)
        facts.blocking.append(
            (f".{func.attr}()", frozenset(held), call, excl))

    def _queue_get(self, func: ast.Attribute, facts: _Facts,
                   types: dict[str, str]) -> bool:
        """Is the `.get` receiver a stdlib-queue-typed local?"""
        parts = _dotted(func.value)
        return bool(parts) and len(parts) == 1 \
            and types.get(parts[0]) == _STDLIB_QUEUE

    @staticmethod
    def _nonblocking_get(call: ast.Call) -> bool:
        """`q.get(False)` / `q.get(block=False)` returns immediately —
        only the blocking form parks the thread."""
        for kw in call.keywords:
            if kw.arg == "block" \
                    and isinstance(kw.value, ast.Constant):
                return not kw.value.value
        if call.args and isinstance(call.args[0], ast.Constant):
            return not call.args[0].value
        return False

    # -- entry-held fixpoint ------------------------------------------------
    def _entry_fixpoint(self) -> None:
        sites: dict[int, list[tuple[int, frozenset]]] = {}
        for fid, facts in self.facts.items():
            for _node, callee, held in facts.calls:
                if callee is not None:
                    sites.setdefault(callee, []).append((fid, held))
        self.entry = {fid: (_TOP if fid in sites else frozenset())
                      for fid in self.facts}
        for _ in range(64):
            changed = False
            for callee, slist in sites.items():
                acc: frozenset | None = _TOP
                for caller, hlex in slist:
                    ec = self.entry.get(caller, frozenset())
                    contrib = _TOP if ec is _TOP else (hlex | ec)
                    if contrib is _TOP:
                        continue
                    acc = contrib if acc is _TOP else (acc & contrib)
                if acc is not _TOP and acc != self.entry[callee]:
                    self.entry[callee] = acc
                    changed = True
            if not changed:
                break
        for fid, v in self.entry.items():
            if v is _TOP:       # cycles with no external caller
                self.entry[fid] = frozenset()

    def _held_full(self, facts: _Facts, held) -> frozenset:
        return frozenset(held) | self.entry.get(id(facts.info),
                                                frozenset())

    # -- JC101 --------------------------------------------------------------
    def _resolve_guards(self) -> None:
        for ci in self.classes.values():
            for attr, (name, line) in ci.guarded_raw.items():
                raw = name[5:] if name.startswith("self.") else name
                lockid = None
                if "." in raw:          # ClassName._lock cross-class
                    cls, _, lattr = raw.rpartition(".")
                    tci = self.classes.get(
                        self._classkey_for_name(cls, ci.module) or "")
                    if tci and lattr in tci.locks:
                        lockid = tci.locks[lattr].lockid
                elif raw in ci.locks:
                    lockid = ci.locks[raw].lockid
                if lockid is None:
                    self._emit(
                        ci.module, ast.Pass(lineno=line, col_offset=0),
                        "JC101",
                        f"guarded-by names `{raw}` but no such lock is "
                        f"declared on {ci.qual} — annotate the lock "
                        "declaration or fix the name")
                else:
                    ci.guard[attr] = lockid

    def _check_jc101(self) -> None:
        by_class: dict[str, list[_Facts]] = {}
        for facts in self.facts.values():
            if facts.clskey:
                by_class.setdefault(facts.clskey, []).append(facts)
        for key, ci in self.classes.items():
            flist = by_class.get(key, [])
            for facts in flist:
                if facts.is_ctor:
                    continue
                for attr, held, node, _w in facts.accesses:
                    g = ci.guard.get(attr)
                    if g is None:
                        continue
                    if g not in self._held_full(facts, held):
                        self._emit(
                            facts.info.module, node, "JC101",
                            f"`self.{attr}` is guarded-by "
                            f"{_short(g)} but accessed without it "
                            "held (not lexically, and not every call "
                            "site of this helper holds it)")
            self._infer_jc101(ci, flist)

    def _infer_jc101(self, ci: ClassInfo, flist: list[_Facts]) -> None:
        if not ci.locks:
            return
        per_attr: dict[str, list[tuple]] = {}
        for facts in flist:
            if facts.is_ctor:
                continue
            for attr, held, node, is_write in facts.accesses:
                if attr in ci.guard or attr in ci.locks:
                    continue
                per_attr.setdefault(attr, []).append(
                    (self._held_full(facts, held), is_write, node,
                     facts))
        for attr, sites in per_attr.items():
            if len(sites) < 5:
                continue
            counts: dict[str, int] = {}
            for held, _w, _n, _f in sites:
                for lid in held:
                    counts[lid] = counts.get(lid, 0) + 1
            best = max(counts, key=counts.get, default=None)
            if best is None or counts[best] / len(sites) < 0.8:
                continue
            for held, is_write, node, facts in sites:
                if is_write and best not in held:
                    self._emit(
                        facts.info.module, node, "JC101",
                        f"`self.{attr}` is written without "
                        f"{_short(best)} held, but "
                        f"{counts[best]}/{len(sites)} of its accesses "
                        "hold that lock (inferred guarded-by) — take "
                        "the lock or annotate the intended protocol")

    # -- JC102 --------------------------------------------------------------
    def _acq_star(self) -> dict[int, set[str]]:
        acq = {fid: {a[0] for a in facts.acquires}
               for fid, facts in self.facts.items()}
        for _ in range(64):
            changed = False
            for fid, facts in self.facts.items():
                for _node, callee, _held in facts.calls:
                    if callee is not None and not \
                            acq[callee] <= acq[fid]:
                        acq[fid] |= acq[callee]
                        changed = True
            if not changed:
                break
        return acq

    def _suppressed(self, mod: ModuleInfo, node: ast.AST,
                    rule: str) -> bool:
        if mod.file_disabled is None or rule in mod.file_disabled:
            return True
        rules = mod.disabled.get(getattr(node, "lineno", 0), ())
        return rules is None or rule in rules

    def _check_jc102(self, acq: dict[int, set[str]]) -> None:
        # a pragma on an acquisition site removes its EDGE from the
        # graph (declaring that nesting safe dissolves the cycle, so
        # the partner edge does not keep reporting it)
        edges: dict[tuple[str, str], tuple[ModuleInfo, ast.AST]] = {}
        for fid, facts in self.facts.items():
            mod = facts.info.module
            ef = self.entry.get(fid, frozenset())
            for lid, held, node in facts.acquires:
                if self._suppressed(mod, node, "JC102"):
                    continue
                for h in frozenset(held) | ef:
                    if h != lid:
                        edges.setdefault((h, lid), (mod, node))
            for node, callee, held in facts.calls:
                if callee is None \
                        or self._suppressed(mod, node, "JC102"):
                    continue
                hf = frozenset(held) | ef
                for lid in acq[callee]:
                    for h in hf:
                        if h != lid:
                            edges.setdefault((h, lid), (mod, node))
        graph: dict[str, set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for scc in self._sccs(graph):
            if len(scc) < 2:
                continue
            members = " -> ".join(sorted(_short(x) for x in scc))
            for (a, b), (mod, node) in sorted(
                    edges.items(),
                    key=lambda kv: (kv[1][0].name,
                                    getattr(kv[1][1], "lineno", 0))):
                if a in scc and b in scc:
                    self._emit(
                        mod, node, "JC102",
                        f"acquiring {_short(b)} while holding "
                        f"{_short(a)} closes a lock-order cycle "
                        f"[{members}] — an interleaving of these "
                        "paths deadlocks; pick one global order")

    @staticmethod
    def _sccs(graph: dict[str, set[str]]) -> list[set[str]]:
        """Iterative Tarjan (graphs here are tiny but recursion-free
        keeps pathological fixtures safe)."""
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on: set[str] = set()
        stack: list[str] = []
        out: list[set[str]] = []
        counter = [0]

        for root in graph:
            if root in index:
                continue
            work = [(root, iter(sorted(graph[root])))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(sorted(graph[w]))))
                        advanced = True
                        break
                    if w in on:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    scc = set()
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        scc.add(w)
                        if w == v:
                            break
                    out.append(scc)
        return out

    # -- JC103 --------------------------------------------------------------
    def _block_reasons(self) -> dict[int, str]:
        reason: dict[int, str] = {}
        for fid, facts in self.facts.items():
            if facts.blocking:
                descs = sorted(b[0] for b in facts.blocking)
                reason[fid] = descs[0]
        for _ in range(64):
            changed = False
            for fid, facts in self.facts.items():
                if fid in reason:
                    continue
                for _node, callee, _held in facts.calls:
                    if callee in reason:
                        cname = self.facts[callee].info.fq.rsplit(
                            ".", 1)[-1]
                        reason[fid] = f"{cname}() -> {reason[callee]}"
                        changed = True
                        break
            if not changed:
                break
        return reason

    def _check_jc103(self) -> None:
        service = {lid for lid, d in self.locks.items()
                   if d.service_tier}
        if not service:
            return
        reason = self._block_reasons()
        for fid, facts in self.facts.items():
            mod = facts.info.module
            for desc, held, node, excl in facts.blocking:
                hf = self._held_full(facts, held)
                if excl is not None:
                    hf = hf - {excl}
                sl = sorted(hf & service)
                if sl:
                    self._emit(
                        mod, node, "JC103",
                        f"blocking {desc} while holding "
                        f"{_short(sl[0])} — one slow peer stalls "
                        "every thread queued on that lock; move the "
                        "blocking call outside the critical section")
            for node, callee, held in facts.calls:
                if callee is None or callee not in reason:
                    continue
                hf = self._held_full(facts, held)
                sl = sorted(hf & service)
                if not sl:
                    continue
                # the callee self-reports when it is itself entry-held
                # under a service lock: exactly one report per chain
                if self.entry.get(callee, frozenset()) & service:
                    continue
                cname = self.facts[callee].info.fq.rsplit(".", 1)[-1]
                self._emit(
                    mod, node, "JC103",
                    f"call into blocking path `{cname}() -> "
                    f"{reason[callee]}` while holding "
                    f"{_short(sl[0])} — move it outside the "
                    "critical section")

    # -- run ---------------------------------------------------------------
    def run(self) -> list[Violation]:
        self._collect()
        self._scan_functions()
        self._entry_fixpoint()
        self._check_jc101()
        self._check_jc102(self._acq_star())
        self._check_jc103()
        return self._dedupe()


def default_paths() -> list[Path]:
    root = Path(__file__).resolve().parents[1]
    return [root / d for d in ("serve", "telemetry",
                               "resilience", "interop")
            if (root / d).exists()]


def check_paths(paths: list[str | Path]) -> list[Violation]:
    """Concurrency-check files/directories; returns sorted violations."""
    checker = ConcurrencyChecker()
    checker.load([Path(p) for p in paths])
    return checker.run()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aclswarm_torch.analysis.concurrency",
        description="torchcheck concurrency tier: lock-discipline "
                    "static analysis (JC101-JC103)")
    ap.add_argument("paths", nargs="*",
                    default=[str(p) for p in default_paths()],
                    help="files or directories (default: the four "
                         "host-side dirs)")
    args = ap.parse_args(argv)
    violations = check_paths(args.paths)
    for v in violations:
        print(v)
    n = len(violations)
    print(f"torchcheck-concurrency: {n} violation"
          f"{'s' if n != 1 else ''} in {len(args.paths)} path(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
