"""`torchcheck` layer 1: AST lint of the port's device path (JC001–JC006).

Why an AST pass and not runtime checks: the defect classes below are
*silent* on the CPU (a host read inside a tick is just a slower tick; a
dtype-less constructor is just a float32 tensor in a float64 run) and
only show on the card, as a stalled stream or a changed result. The
linter makes them loud at review time.

The device path has no decorator to find it by, so it is marked: a
``# torchcheck: device-path`` comment on a ``def`` line (or on any line
of its signature) makes that function a root, and every function the
call graph reaches from a root is device-path code. `sim.engine.step` and
every function `analysis.trace_audit` registers carry the marker.

Rules, on device-path code unless said otherwise:

- **JC001 host-sync-on-device-path** — `.item()`, `.tolist()`,
  `.cpu()`, `.numpy()`, `.synchronize()`, `float/int/bool(...)` of a
  non-static value, `np.asarray`/`np.array`/`np.copyto`, and
  `torch.cuda.synchronize`. Each is a device-to-host read (or a wait on
  the stream) that stalls the host behind the card's queue. A poll that
  the port makes on purpose (a data-dependent loop reading its done flag
  every K rounds) carries a pragma that gives its reason.
- **JC002 python-control-flow-on-tensor** — `if`/`while` (and `x if c
  else y`) whose test reads a tensor parameter: an implicit `bool()`,
  so a host read. Parameters are presumed static when their annotation
  is a Python-static type (`int`, `str`, `bool`, `float`, `tuple`,
  optionally `| None`), when their default is a Python literal, or when
  their name is in `STATIC_PARAM_NAMES`; `is None` tests,
  `.shape`/`.ndim`/`.dtype` accesses, `isinstance`, and comparisons
  against string literals are always allowed.
- **JC003 dtype-less-constructor** — `torch.tensor`/`torch.as_tensor`
  of a bare name or numeric literal with no ``dtype=``;
  `torch.zeros/ones/full/empty/arange/linspace` with no ``dtype=`` (they
  take the global default, float32, whatever the run's dtype); and
  `torch.*_like` whose source is a Python scalar. Also checked inside
  ``dataclasses.field(default_factory=lambda: ...)`` factories. Every
  constructor of the port takes an explicit dtype.
- **JC004 host-nondeterminism-on-device-path** — `time.time`/
  `perf_counter`/`monotonic`, `np.random.*`, stdlib `random.*`, and
  torch's global generator (`torch.rand/randn/randint/randperm/normal/
  bernoulli/multinomial` and the `*_like` forms without
  ``generator=``). The port's device randomness is `core.prng`.
- **JC005** — reserved, with no counterpart: eager torch has no buffer
  donation. The staging store's in-place writes (`serve.staging`,
  `index_copy_`) leave every buffer valid, so there is no
  read-after-donate to catch.
- **JC006 unmasked-reduction** — `torch.sum/mean/min/max/amin/amax/
  argmin/argmax` and the method forms (`x.sum()`, `x.mean()`, ...) in
  the fault-aware modules (`sim/`, `assignment/`, `control/`,
  `faults/`, `scenarios/`) inside a function that handles an
  alive/link mask, where NO mask feeds the reduced operand
  (transitively through local assignments, flow-insensitively). A
  reduction over the agent axis that forgets the dead rows (a frozen
  vehicle's pose polluting a mean, a dead bidder winning an argmin).
  This rule does not need the device path.

Escape hatch: append ``# torchcheck: disable=JC001 <reason>`` (comma-
separate several rules, or omit ``=...`` to disable all rules) to the
offending line. File-level: a ``# torchcheck: disable-file=JC001,JC006``
comment anywhere in a file disables those rules for the whole file
(omit ``=...`` to disable all). A file outside the fault-aware modules
opts into JC006 with ``# torchcheck: fault-aware-file``.

Run standalone: ``python -m aclswarm_torch.analysis.lint [paths...]``
(default: the whole port); ``--concurrency`` runs JC101–JC103,
``--protocol`` JC201–JC204, ``--all`` every tier. Exit 1 on any
violation.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import re
import sys
from pathlib import Path

# ---------------------------------------------------------------------------
# configuration

RULES = {
    "JC001": "host sync reachable from the device path",
    "JC002": "python control flow on a tensor value",
    "JC003": "dtype-less tensor constructor",
    "JC004": "host nondeterminism on the device path",
    "JC005": "reserved (eager torch donates no buffer)",
    "JC006": "unmasked reduction in fault-aware code",
}

# parameter names presumed static even without annotation — the
# codebase's conventional config/static spellings (JC002 allowlist)
STATIC_PARAM_NAMES = {
    "self", "cls", "cfg", "config", "params", "dtype", "shape", "axis",
    "n", "d", "mode", "impl", "static", "planar", "window", "device",
}

# annotations that mark a parameter as a Python-static value
_STATIC_ANN_NAMES = {"int", "str", "bool", "float", "tuple", "bytes",
                     "list", "dict"}

# attribute accesses that are static regardless of the root object
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda"}

# JC001 call targets (fq) and method names
_HOST_SYNC_FQ = {
    "torch.cuda.synchronize", "numpy.asarray", "numpy.array",
    "numpy.copyto",
}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_SYNC_CASTS = {"float", "int", "bool"}
# calls whose value is a host number whatever their argument
_STATIC_CALLS = {"len", "numel", "dim", "size", "isinstance", "range",
                 "min", "max", "round", "getattr"}
# host queries a JC002 test may make on a tensor without reading it
_STATIC_QUERIES = {"isinstance", "len", "hasattr", "getattr", "callable",
                   "is_dataclass", "is_contiguous", "is_floating_point",
                   "dim", "numel", "size"}
# fields the port keeps on the host by design: a state's tick (the
# decimation phase) and a scenario's host copy of its onsets
_HOST_ATTRS = {"tick", "_host"}

# JC004 call targets: exact fq names, and fq prefixes (module trees)
_NONDET_FQ = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
}
_NONDET_PREFIXES = ("numpy.random.", "random.", "secrets.", "uuid.")
# torch's global generator: nondeterministic unless `generator=` is given
_GLOBAL_RNG = {"torch." + f for f in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like")}

# JC003 constructors
_TENSOR_CTORS = {"torch.tensor", "torch.as_tensor"}
_SHAPE_CTORS = {"torch." + f for f in (
    "zeros", "ones", "full", "empty", "arange", "linspace")}
_LIKE_CTORS = {"torch." + f for f in (
    "zeros_like", "ones_like", "full_like", "empty_like")}

# JC006: the modules where fault/scenario masking is load-bearing.
# Fixture / out-of-tree files opt in with a `# torchcheck:
# fault-aware-file` comment.
_JC006_MODULE_PREFIXES = ("aclswarm_torch.sim", "aclswarm_torch.assignment",
                          "aclswarm_torch.control", "aclswarm_torch.faults",
                          "aclswarm_torch.scenarios")
_REDUCTION_NAMES = ("sum", "mean", "min", "max", "amin", "amax", "argmin",
                    "argmax")
# reductions that silently fold dead/masked rows into their result
_JC006_REDUCTIONS = {"torch." + r for r in _REDUCTION_NAMES}
_JC006_METHODS = set(_REDUCTION_NAMES)
# identifier tokens that mark a value as mask-derived (split on
# underscores; `*mask` suffixes like `neighbor_mask`/`comm_mask` match)
_MASKISH_TOKENS = {"alive", "dead", "mask", "masked", "pin", "pinned",
                   "forbid", "forbidden", "comm"}


def _is_maskish(name: str) -> bool:
    parts = [p for p in re.split(r"[_\W0-9]+", name.lower()) if p]
    return any(p in _MASKISH_TOKENS or p.endswith("mask") for p in parts)


# `disable` must not swallow `disable-file` (negative lookahead); the
# rule list ends at the first word that is not a rule id, so a reason
# may follow it on the same line
_RULE_LIST = r"([A-Za-z]{2}[0-9]{3}(?:\s*,\s*[A-Za-z]{2}[0-9]{3})*)"
_DISABLE_RE = re.compile(
    r"#\s*torchcheck:\s*disable(?!-file)(?:\s*=\s*" + _RULE_LIST + ")?")
_DISABLE_FILE_RE = re.compile(
    r"#\s*torchcheck:\s*disable-file(?:\s*=\s*" + _RULE_LIST + ")?")
_FAULT_AWARE_FILE_RE = re.compile(r"#\s*torchcheck:\s*fault-aware-file")
_DEVICE_PATH_RE = re.compile(r"#\s*torchcheck:\s*device-path")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# module model

@dataclasses.dataclass
class FuncInfo:
    """One function/method/lambda and its lint-relevant facts."""

    fq: str                       # module.qualname
    module: "ModuleInfo"
    node: ast.AST                 # FunctionDef | AsyncFunctionDef | Lambda
    parent: "FuncInfo | None"
    params: list[str] = dataclasses.field(default_factory=list)
    static_params: set[str] = dataclasses.field(default_factory=set)
    device_root: bool = False
    children: dict[str, "FuncInfo"] = dataclasses.field(default_factory=dict)
    calls: list[tuple[ast.Call, "FuncInfo"]] = \
        dataclasses.field(default_factory=list)   # (call node, scope)


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: Path
    tree: ast.Module
    lines: list[str] = dataclasses.field(default_factory=list)
    aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    defs: dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    funcs: list[FuncInfo] = dataclasses.field(default_factory=list)
    lambdas: list[FuncInfo] = dataclasses.field(default_factory=list)
    factories: list[ast.Lambda] = dataclasses.field(default_factory=list)
    disabled: dict[int, set | None] = dataclasses.field(default_factory=dict)
    # file-level pragma state: empty set = nothing disabled file-wide,
    # None = ALL rules disabled (`# torchcheck: disable-file`)
    file_disabled: set | None = dataclasses.field(default_factory=set)
    # `# torchcheck: fault-aware-file` opt-in (JC006 outside its modules)
    fault_aware_file: bool = False


def _module_name(path: Path) -> str:
    """Dotted module name by walking up through package __init__ files."""
    path = path.resolve()
    parts = [path.stem] if path.stem != "__init__" else []
    d = path.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        d = d.parent
    return ".".join(parts) or path.stem


def _dotted(node: ast.AST) -> list[str] | None:
    """Name/Attribute chain -> ['a', 'b', 'c'] for a.b.c, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.insert(0, node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.insert(0, node.id)
        return parts
    return None


def _is_static_annotation(ann: ast.AST | None) -> bool:
    """int / str / bool / float / tuple, optionally `| None` / Optional."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):           # string annotations
        return any(t in str(ann.value).replace(" ", "").split("|")
                   for t in _STATIC_ANN_NAMES)
    if isinstance(ann, ast.Name):
        return ann.id in _STATIC_ANN_NAMES
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        sides = [ann.left, ann.right]
        return any(_is_static_annotation(s) for s in sides
                   if not (isinstance(s, ast.Constant) and s.value is None))
    if isinstance(ann, ast.Subscript):          # Optional[int] etc.
        base = _dotted(ann.value)
        if base and base[-1] in ("Optional", "Union"):
            return _is_static_annotation(ann.slice)
    return False


def _parse_rules(group: str | None) -> set | None:
    return ({r.strip().upper() for r in group.split(",")}
            if group else None)


# ---------------------------------------------------------------------------
# pass A: per-module collection

class _Collector(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.scope: list[FuncInfo] = []
        self.qual: list[str] = []

    # -- imports -> alias map ------------------------------------------------
    def visit_Import(self, node: ast.Import):
        for a in node.names:
            if a.asname:                 # `import numpy as np`
                self.mod.aliases[a.asname] = a.name
            else:                        # `import torch.nn` binds `torch`
                head = a.name.split(".")[0]
                self.mod.aliases.setdefault(head, head)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.level:      # relative: resolve against this module's package
            pkg = self.mod.name.split(".")
            # drop the module's own leaf unless it's a package __init__
            if self.mod.path.stem != "__init__":
                pkg = pkg[:-1]
            pkg = pkg[:len(pkg) - (node.level - 1)]
            base = ".".join(pkg + ([node.module] if node.module else []))
        else:
            base = node.module or ""
        for a in node.names:
            if a.name == "*":
                continue
            self.mod.aliases[a.asname or a.name] = f"{base}.{a.name}"
        self.generic_visit(node)

    # -- defs ---------------------------------------------------------------
    def _marked_device_path(self, node) -> bool:
        """A ``# torchcheck: device-path`` comment on the def line or on
        any line of its signature (up to the first body statement)."""
        last = node.body[0].lineno - 1 if node.body else node.lineno
        lines = self.mod.lines
        return any(_DEVICE_PATH_RE.search(lines[i - 1])
                   for i in range(node.lineno, max(last, node.lineno) + 1)
                   if 0 < i <= len(lines))

    def _make_func(self, node, name: str) -> FuncInfo:
        fq = ".".join([self.mod.name] + self.qual + [name])
        info = FuncInfo(fq=fq, module=self.mod, node=node,
                        parent=self.scope[-1] if self.scope else None)
        args = node.args
        params, statics = [], set()
        all_args = (args.posonlyargs + args.args + args.kwonlyargs
                    + ([args.vararg] if args.vararg else [])
                    + ([args.kwarg] if args.kwarg else []))
        ndef = len(args.defaults)
        defaulted = {a.arg for a in (args.posonlyargs + args.args)[-ndef:]
                     } if ndef else set()
        defaulted |= {a.arg for a, d in zip(args.kwonlyargs, args.kw_defaults)
                      if d is not None}
        for a in all_args:
            params.append(a.arg)
            ann_static = _is_static_annotation(getattr(a, "annotation", None))
            if (a.arg in STATIC_PARAM_NAMES or ann_static
                    or a.arg in defaulted):
                statics.add(a.arg)
        info.params = params
        info.static_params = statics
        if not isinstance(node, ast.Lambda):
            info.device_root = self._marked_device_path(node)
        if self.scope:
            self.scope[-1].children[name] = info
        return info

    def visit_FunctionDef(self, node):
        info = self._make_func(node, node.name)
        self.mod.funcs.append(info)
        self.mod.defs[".".join(self.qual + [node.name])] = info
        self.scope.append(info)
        self.qual.append(node.name)
        self.generic_visit(node)
        self.qual.pop()
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef):
        self.qual.append(node.name)
        self.generic_visit(node)
        self.qual.pop()

    def visit_Lambda(self, node: ast.Lambda):
        info = self._make_func(node, f"<lambda L{node.lineno}>")
        self.mod.lambdas.append(info)
        self.scope.append(info)
        self.generic_visit(node)
        self.scope.pop()

    def visit_Call(self, node: ast.Call):
        if self.scope:
            self.scope[-1].calls.append((node, self.scope[-1]))
        # default_factory lambdas run on every dataclass instantiation:
        # collect them for JC003 regardless of reachability
        for k in node.keywords:
            if k.arg == "default_factory" and isinstance(k.value, ast.Lambda):
                self.mod.factories.append(k.value)
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# linter

class Linter:
    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.violations: list[Violation] = []

    # -- loading ------------------------------------------------------------
    def load(self, paths: list[Path]) -> None:
        files: list[Path] = []
        for p in paths:
            p = Path(p)
            files += sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            src = f.read_text()
            mod = ModuleInfo(name=_module_name(f), path=f,
                             tree=ast.parse(src, filename=str(f)),
                             lines=src.splitlines())
            for i, line in enumerate(mod.lines, 1):
                m = _DISABLE_RE.search(line)
                if m:
                    mod.disabled[i] = _parse_rules(m.group(1))
                fm = _DISABLE_FILE_RE.search(line)
                if fm and mod.file_disabled is not None:
                    rules = _parse_rules(fm.group(1))
                    if rules is None:
                        mod.file_disabled = None        # all rules
                    else:
                        mod.file_disabled |= rules
                if _FAULT_AWARE_FILE_RE.search(line):
                    mod.fault_aware_file = True
            _Collector(mod).visit(mod.tree)
            self.modules[mod.name] = mod

    # -- cross-module resolution --------------------------------------------
    def _resolve(self, mod: ModuleInfo, parts: list[str],
                 scope: FuncInfo | None = None, _depth: int = 0
                 ) -> "FuncInfo | str | None":
        """Resolve a dotted call target to a FuncInfo (repo function), a
        fq string (external, e.g. 'torch.zeros'), or None."""
        if not parts or _depth > 8:
            return None
        # lexical scope chain: nested defs visible to enclosing functions
        s = scope
        while s is not None and len(parts) == 1:
            if parts[0] in s.children:
                return s.children[parts[0]]
            s = s.parent
        # self.method -> any method of an enclosing/any class in module
        if parts[0] in ("self", "cls") and len(parts) == 2:
            for qual, info in mod.defs.items():
                if qual.split(".")[-1] == parts[1] and "." in qual:
                    return info
            return None
        # module-local definition (possibly Class.method)
        if ".".join(parts) in mod.defs:
            return mod.defs[".".join(parts)]
        if parts[0] in mod.defs:
            return mod.defs[parts[0]]
        # alias expansion
        head = mod.aliases.get(parts[0])
        if head is None:
            return None
        fq = head.split(".") + parts[1:]
        return self._resolve_fq(fq, _depth + 1)

    def _resolve_fq(self, parts: list[str], _depth: int = 0
                    ) -> "FuncInfo | str | None":
        fqs = ".".join(parts)
        # longest module prefix owned by the repo
        for cut in range(len(parts), 0, -1):
            mname = ".".join(parts[:cut])
            if mname in self.modules:
                tmod = self.modules[mname]
                rest = parts[cut:]
                if not rest:
                    return fqs
                if ".".join(rest) in tmod.defs:
                    return tmod.defs[".".join(rest)]
                # re-export through the target module's imports
                if rest[0] in tmod.aliases:
                    tgt = tmod.aliases[rest[0]].split(".") + rest[1:]
                    return self._resolve_fq(tgt, _depth + 1)
                return fqs
        return fqs      # external (torch.zeros, numpy.asarray, ...)

    # -- reachability -------------------------------------------------------
    def _device_set(self) -> set[int]:
        """ids of FuncInfos reachable from a ``device-path`` root."""
        roots = [info for mod in self.modules.values()
                 for info in mod.funcs if info.device_root]
        seen: set[int] = set()
        stack = roots[:]
        while stack:
            f = stack.pop()
            if id(f) in seen:
                continue
            seen.add(id(f))
            # lambdas nested in device-path code run on the same path
            for child in f.children.values():
                if isinstance(child.node, ast.Lambda):
                    stack.append(child)
            for call, scope in f.calls:
                parts = _dotted(call.func)
                if parts:
                    t = self._resolve(f.module, parts, scope)
                    if isinstance(t, FuncInfo):
                        stack.append(t)
                # functions passed as arguments (callbacks, loop bodies)
                for a in call.args:
                    ap = _dotted(a)
                    if ap:
                        ta = self._resolve(f.module, ap, scope)
                        if isinstance(ta, FuncInfo) and id(ta) not in seen:
                            stack.append(ta)
        return seen

    # -- rule machinery -----------------------------------------------------
    def _emit(self, mod: ModuleInfo, node: ast.AST, rule: str, msg: str):
        line = getattr(node, "lineno", 0)
        if mod.file_disabled is None or rule in mod.file_disabled:
            return
        if line in mod.disabled:
            rules = mod.disabled[line]
            if rules is None or rule in rules:
                return
        self.violations.append(
            Violation(str(mod.path), line, rule, msg))

    def _call_fq(self, mod: ModuleInfo, call: ast.Call,
                 scope: FuncInfo | None) -> str | None:
        parts = _dotted(call.func)
        if not parts:
            return None
        t = self._resolve(mod, parts, scope)
        return t if isinstance(t, str) else (t.fq if t else None)

    @staticmethod
    def _iter_own_body(info: FuncInfo):
        """Nodes of this function's body, NOT descending into nested
        defs/lambdas (they are separate FuncInfos, checked when they are
        themselves reachable). The nested-def test applies to the popped
        node itself, not only to grandchildren: a `def` that is a direct
        statement of the body must be skipped too, or every violation in
        it is double-reported (once for it, once for its parent)."""
        if isinstance(info.node, ast.Lambda):
            start = [info.node.body]
        else:
            start = list(info.node.body)
        stack = start[:]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # the nested BODY is a separate FuncInfo, but its
                # decorators and argument defaults evaluate in THIS
                # scope — keep scanning those
                if not isinstance(node, ast.Lambda):
                    stack.extend(node.decorator_list)
                args = node.args
                stack.extend(d for d in args.defaults)
                stack.extend(d for d in args.kw_defaults if d is not None)
                continue
            yield node
            for child in ast.iter_child_nodes(node):
                stack.append(child)

    # JC001 / JC002 / JC003 / JC004 share a walk over a device-path body
    def _check_device_body(self, info: FuncInfo) -> None:
        mod = info.module
        for node in self._iter_own_body(info):
            if isinstance(node, ast.Call):
                self._check_call(info, mod, node)
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                self._check_jc002(info, mod, node, node.test)

    def _static_value(self, info: FuncInfo, expr: ast.AST) -> bool:
        """Is `expr` a host value by construction (a literal, a shape, a
        length, a static parameter, a host field, a numpy or math result,
        or arithmetic and comparisons over those)?"""
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, (ast.List, ast.Tuple)):
            return all(self._static_value(info, e) for e in expr.elts)
        if isinstance(expr, ast.Attribute):
            return expr.attr in _STATIC_ATTRS | _HOST_ATTRS \
                or self._static_value(info, expr.value)
        if isinstance(expr, ast.Subscript):
            return self._static_value(info, expr.value)
        if isinstance(expr, ast.Call):
            fq = self._call_fq(info.module, expr, info)
            if fq and fq.startswith(("numpy.", "math.")):
                return True
            if isinstance(expr.func, ast.Attribute) \
                    and isinstance(expr.func.value, ast.Call):
                return self._static_value(info, expr.func.value)
            parts = _dotted(expr.func)
            return bool(parts) and parts[-1] in _STATIC_CALLS
        if isinstance(expr, ast.Compare):
            return all(self._static_value(info, e)
                       for e in [expr.left] + list(expr.comparators))
        if isinstance(expr, ast.BoolOp):
            return all(self._static_value(info, e) for e in expr.values)
        if isinstance(expr, ast.Name):
            # a static parameter, or a module constant (UPPER_CASE)
            return expr.id.isupper() or any(
                expr.id in s.static_params for s in self._chain(info))
        if isinstance(expr, ast.BinOp):
            return self._static_value(info, expr.left) \
                and self._static_value(info, expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self._static_value(info, expr.operand)
        return False

    @staticmethod
    def _chain(info: FuncInfo):
        s: FuncInfo | None = info
        while s is not None:
            yield s
            s = s.parent

    def _check_call(self, info: FuncInfo, mod: ModuleInfo,
                    call: ast.Call) -> None:
        fq = self._call_fq(mod, call, info)
        func = call.func
        # JC001: host syncs
        if isinstance(func, ast.Attribute) \
                and func.attr in _HOST_SYNC_METHODS \
                and not (fq and fq.startswith("torch.")
                         and fq != "torch.cuda.synchronize"):
            self._emit(mod, call, "JC001",
                       f".{func.attr}() reads the device on the host "
                       "inside a device-path function")
        elif fq in _HOST_SYNC_FQ and not (
                call.args and self._static_value(info, call.args[0])):
            self._emit(mod, call, "JC001",
                       f"{fq} waits for or copies from the device inside "
                       "a device-path function")
        elif (isinstance(func, ast.Name) and func.id in _HOST_SYNC_CASTS
              and call.args
              and not self._static_value(info, call.args[0])):
            self._emit(mod, call, "JC001",
                       f"{func.id}(...) of a tensor is a device-to-host "
                       "read inside a device-path function")
        # JC004: nondeterminism
        if fq and (fq in _NONDET_FQ
                   or any(fq.startswith(p) for p in _NONDET_PREFIXES)):
            self._emit(mod, call, "JC004",
                       f"{fq} puts a host value into the device path "
                       "(not reproducible run to run); use core.prng")
        elif fq in _GLOBAL_RNG and not any(k.arg == "generator"
                                           for k in call.keywords):
            self._emit(mod, call, "JC004",
                       f"{fq} draws from torch's global generator "
                       "(not reproducible across runs or devices); use "
                       "core.prng or pass generator=")
        # JC003: dtype-less constructors
        self._check_jc003(mod, call, fq)

    def _check_jc003(self, mod: ModuleInfo, call: ast.Call,
                     fq: str | None) -> None:
        if fq is None or any(k.arg == "dtype" for k in call.keywords):
            return
        name = fq.split(".")[-1]
        if fq in _TENSOR_CTORS:
            if len(call.args) >= 2 or not call.args:
                return
            if self._weak_candidate(call.args[0]):
                self._emit(mod, call, "JC003",
                           f"dtype-less torch.{name}(...) — a Python "
                           "number takes the default dtype and a bare "
                           "name inherits the caller's; pass dtype=")
        elif fq in _SHAPE_CTORS:
            self._emit(mod, call, "JC003",
                       f"dtype-less torch.{name}(...) takes its dtype "
                       "from its arguments or the global default, whatever "
                       "the run's dtype; pass dtype=")
        elif fq in _LIKE_CTORS and call.args \
                and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, (int, float)):
            self._emit(mod, call, "JC003",
                       f"torch.{name}(...) of a Python scalar takes the "
                       "default dtype; pass dtype=")

    @staticmethod
    def _weak_candidate(arg: ast.AST) -> bool:
        """Arguments whose dtype depends on the caller / Python literals."""
        if isinstance(arg, ast.Constant):
            return isinstance(arg.value, (int, float, complex)) \
                and not isinstance(arg.value, bool)
        if isinstance(arg, ast.Name):
            return True
        if isinstance(arg, ast.UnaryOp):
            return Linter._weak_candidate(arg.operand)
        if isinstance(arg, (ast.List, ast.Tuple)):
            return any(Linter._weak_candidate(e) for e in arg.elts)
        return False

    # -- JC002 --------------------------------------------------------------
    def _check_jc002(self, info: FuncInfo, mod: ModuleInfo,
                     node: ast.AST, test: ast.AST) -> None:
        offenders = self._traced_names_in_test(info, test)
        for name in sorted(offenders):
            kind = "while" if isinstance(node, ast.While) else "if"
            self._emit(
                mod, node, "JC002",
                f"python `{kind}` on tensor parameter `{name}` — an "
                "implicit bool() reads the device on the host; use "
                "torch.where, or mark the parameter static")

    def _traced_names_in_test(self, info: FuncInfo,
                              test: ast.AST) -> set[str]:
        # collect parameter names from the lexical scope chain
        traced: dict[str, bool] = {}
        for s in self._chain(info):
            for p in s.params:
                if p not in traced:
                    traced[p] = p not in s.static_params

        offenders: set[str] = set()

        def walk(n: ast.AST, safe: bool) -> None:
            if isinstance(n, ast.Compare):
                ops_safe = all(isinstance(o, (ast.Is, ast.IsNot))
                               for o in n.ops)
                # comparisons against string literals are static mode
                # switches (assignment/localization/impl selectors)
                str_cmp = any(isinstance(c, ast.Constant)
                              and isinstance(c.value, str)
                              for c in [n.left] + list(n.comparators))
                for child in [n.left] + list(n.comparators):
                    walk(child, safe or ops_safe or str_cmp)
                return
            if isinstance(n, ast.Call):
                fqp = _dotted(n.func)
                if fqp and fqp[-1] in _STATIC_QUERIES:
                    return          # static introspection
                walk(n.func, safe)
                for a in list(n.args) + [k.value for k in n.keywords]:
                    walk(a, safe)
                return
            if isinstance(n, ast.Attribute):
                if n.attr in _STATIC_ATTRS:
                    return          # .shape / .ndim / .dtype are static
                walk(n.value, safe)
                return
            if isinstance(n, ast.Name):
                if not safe and traced.get(n.id, False):
                    offenders.add(n.id)
                return
            for child in ast.iter_child_nodes(n):
                walk(child, safe)

        walk(test, False)
        return offenders

    # -- JC006 --------------------------------------------------------------
    @staticmethod
    def _expr_names(expr: ast.AST) -> set[str]:
        """All bare names and attribute names in an expression — the
        flow-insensitive provenance alphabet for the mask test."""
        out: set[str] = set()
        for n in ast.walk(expr):
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, ast.Attribute):
                out.add(n.attr)
        return out

    def _check_jc006(self) -> None:
        """Unmasked reductions in fault-aware code.

        Scope (both conditions must hold, keeping the rule quiet on the
        purely-geometric kernels that share these modules):

        1. the module is one of the fault-aware subpackages
           (`_JC006_MODULE_PREFIXES`) or carries the
           ``# torchcheck: fault-aware-file`` opt-in;
        2. the *function* itself handles a mask: a mask-ish identifier
           (`_MASKISH_TOKENS`) appears among its parameters, its body's
           names, or the attributes it reads. A solver that never sees
           an alive mask (`auction_lap`, the Sinkhorn roundings) has no
           masking obligation and is exempt.

        A reduction passes when a mask-ish name reaches its operand
        transitively through the function's local assignments
        (flow-insensitive: any binding of a name contributes — rebinding
        ``cost = apply_pin_forbid(cost, pin, forbid)`` marks `cost`).
        The operand of a method form (``x.sum()``) is its receiver.
        """
        for mod in self.modules.values():
            in_scope = mod.fault_aware_file or any(
                mod.name == p or mod.name.startswith(p + ".")
                for p in _JC006_MODULE_PREFIXES)
            if not in_scope:
                continue
            for info in mod.funcs:
                self._check_jc006_fn(mod, info)

    def _reduction(self, mod: ModuleInfo, node: ast.Call,
                   info: FuncInfo) -> tuple[str, list] | None:
        """(name, operand expressions) if `node` reduces, else None."""
        fq = self._call_fq(mod, node, info)
        if fq in _JC006_REDUCTIONS:
            if not (node.args or node.keywords):
                return None
            return fq, list(node.args[:1]) + [k.value for k in
                                              node.keywords]
        func = node.func
        # a method on a value: its receiver resolves to no module, import
        # or definition (`np.max` and `geometry.sum` do)
        if isinstance(func, ast.Attribute) and func.attr in _JC006_METHODS \
                and fq is None:
            return f"Tensor.{func.attr}", [func.value] + [
                k.value for k in node.keywords]
        return None

    def _check_jc006_fn(self, mod: ModuleInfo, info: FuncInfo) -> None:
        assigns: dict[str, set[str]] = {}
        seen_names: set[str] = set(info.params)
        reductions: list[tuple[ast.Call, str, list]] = []
        for node in self._iter_own_body(info):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = node.value
                if value is None:
                    continue
                rhs = self._expr_names(value)
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for el in ast.walk(t):
                        if isinstance(el, ast.Name):
                            assigns.setdefault(el.id, set()).update(rhs)
            elif isinstance(node, ast.comprehension):
                # `for c in cost` binds c from cost
                rhs = self._expr_names(node.iter)
                for el in ast.walk(node.target):
                    if isinstance(el, ast.Name):
                        assigns.setdefault(el.id, set()).update(rhs)
            elif isinstance(node, ast.Name):
                seen_names.add(node.id)
            elif isinstance(node, ast.Attribute):
                seen_names.add(node.attr)
            elif isinstance(node, ast.Call):
                red = self._reduction(mod, node, info)
                if red is not None:
                    reductions.append((node, red[0], red[1]))
        if not reductions:
            return
        if not any(_is_maskish(x) for x in seen_names):
            return          # function never touches a mask: exempt
        for call, fq, operands in reductions:
            # provenance covers the operand AND every keyword value: a
            # keyword-passed operand (`torch.sum(input=x)`) must not
            # escape
            prov: set[str] = set()
            for a in operands:
                prov |= self._expr_names(a)
            frontier = set(prov)
            for _ in range(32):     # transitive closure, bounded
                step = set()
                for nm in frontier:
                    step |= assigns.get(nm, set())
                step -= prov
                if not step:
                    break
                prov |= step
                frontier = step
            if not any(_is_maskish(x) for x in prov):
                red = fq.rsplit(".", 1)[-1]
                self._emit(
                    mod, call, "JC006",
                    f"{red}(...) in fault-aware code reduces an operand "
                    "no alive/link mask feeds — dead/masked rows fold "
                    "silently into the result; mask the operand "
                    "(torch.where(alive, ...)) or disable with a pragma "
                    "if the full-fleet reduction is intended")

    # -- default_factory JC003 ----------------------------------------------
    def _check_factories(self) -> None:
        for mod in self.modules.values():
            for lam in mod.factories:
                for n in ast.walk(lam):
                    if isinstance(n, ast.Call):
                        self._check_jc003(mod, n,
                                          self._call_fq(mod, n, None))

    # -- run ---------------------------------------------------------------
    def run(self) -> list[Violation]:
        device = self._device_set()
        for mod in self.modules.values():
            for info in mod.funcs + mod.lambdas:
                if id(info) in device:
                    self._check_device_body(info)
        self._check_factories()
        self._check_jc006()
        return self._dedupe()

    def _dedupe(self) -> list[Violation]:
        """One report per (file, line, rule): the same site is reached
        through every call-graph path to it, and differently-worded
        messages for one defect are noise — keep the first message in
        sort order."""
        ordered = sorted(set(self.violations),
                         key=lambda v: (v.path, v.line, v.rule, v.message))
        seen: set[tuple] = set()
        unique: list[Violation] = []
        for v in ordered:
            key = (v.path, v.line, v.rule)
            if key in seen:
                continue
            seen.add(key)
            unique.append(v)
        self.violations = unique
        return self.violations


def device_functions(paths: list[str | Path]) -> set[str]:
    """Fully qualified names of the functions marked ``device-path``."""
    linter = Linter()
    linter.load([Path(p) for p in paths])
    return {info.fq for mod in linter.modules.values()
            for info in mod.funcs if info.device_root}


def lint_paths(paths: list[str | Path]) -> list[Violation]:
    """Lint files/directories; returns sorted violations."""
    linter = Linter()
    linter.load([Path(p) for p in paths])
    return linter.run()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aclswarm_torch.analysis.lint",
        description="torchcheck: AST lint of the port's device path "
                    "(JC001-JC006)")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories (default: aclswarm_torch/; "
                         "with --concurrency/--protocol: that tier's "
                         "default dirs)")
    ap.add_argument("--concurrency", action="store_true",
                    help="run the host-side concurrency tier "
                         "(JC101-JC103) instead of the device-path rules")
    ap.add_argument("--protocol", action="store_true",
                    help="run the serve-protocol conformance tier "
                         "(JC201-JC204) instead of the device-path rules")
    ap.add_argument("--all", action="store_true", dest="all_tiers",
                    help="run every tier (JC0xx + JC1xx + JC2xx) over "
                         "its own default paths; exit 1 if ANY tier "
                         "finds a violation")
    args = ap.parse_args(argv)
    if args.all_tiers:
        # every tier runs (no short-circuit), then the codes OR
        from . import concurrency, protocol
        rc = main(list(args.paths))
        rc |= concurrency.main(list(args.paths))
        rc |= protocol.main([str(p) for p in args.paths])
        return rc
    if args.concurrency:
        # lazy import: the concurrency module imports from this one
        from . import concurrency
        return concurrency.main(args.paths)
    if args.protocol:
        from . import protocol
        return protocol.main([str(p) for p in args.paths])
    paths = args.paths or [str(Path(__file__).resolve().parents[1])]
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    n = len(violations)
    print(f"torchcheck: {n} violation{'s' if n != 1 else ''} "
          f"in {len(paths)} path(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
