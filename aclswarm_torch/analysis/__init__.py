"""Analysis of the port (port of `aclswarm_tpu.analysis`).

- `analysis.invariants` — the runtime invariant sanitizer;
- `analysis.lint` — `torchcheck`, an AST lint of the device path
  (JC001–JC006: host syncs, control flow on tensors, dtype-less
  constructors, host nondeterminism, unmasked reductions; JC005 is
  reserved), with the concurrency (`analysis.concurrency`, JC101–JC103)
  and protocol (`analysis.protocol`, JC201–JC204) tiers;
- `analysis.model` — the explicit-state model checker of the serve
  protocol and the refinement of real journals against it;
- `analysis.trace_audit` — the registry of device-path entry points,
  run with fresh float32 inputs: host syncs within budget on the card,
  the same ATen op stream on a repeated call, no float64 output leaf,
  and the zero-cost-off proof against `aten_baseline.json`.
"""
# lazy re-exports: `python -m aclswarm_torch.analysis.lint` must not
# re-import its own module through the package (runpy double-import),
# and importing the package must stay cheap
_LINT = ("Violation", "lint_paths")
_AUDIT = ("ENTRY_POINTS", "AuditReport", "audit_entry", "audit_all",
          "iter_grid", "register_entry", "GridPoint", "f32_mode")
__all__ = list(_LINT + _AUDIT)


def __getattr__(name):
    if name in _LINT:
        from aclswarm_torch.analysis import lint
        return getattr(lint, name)
    if name in _AUDIT:
        from aclswarm_torch.analysis import trace_audit
        return getattr(trace_audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
