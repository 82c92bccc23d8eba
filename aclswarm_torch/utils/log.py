"""Logging (a copy of `aclswarm_tpu/utils/log.py`): leveled,
env-configurable, ANSI-highlighted.

Stdlib logging with a framework root logger (``aclswarm_torch``),
per-module children, an env knob (``ACLSWARM_LOG=debug`` or
``ACLSWARM_LOG=aclswarm_torch.serve=debug``), and colored warnings on a
tty. Every framework record is also counted into the telemetry registry
(``log_records_total{level=...}``), so log volume by severity is a
metric, not just a stream.

Usage::

    from aclswarm_torch.utils.log import get_logger
    log = get_logger(__name__)
    log.info("committed formation %s", name)
    log.debug("auction trace ...")       # the reference's `verbose` flag
"""
from __future__ import annotations

import logging
import os
import sys

ROOT = "aclswarm_torch"
_COLORS = {
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"
_configured = False


class _TtyFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno)
        if color and sys.stderr.isatty():
            return f"{color}{msg}{_RESET}"
        return msg


class _TelemetryHandler(logging.Handler):
    """Counts every framework log record into the telemetry registry
    (``log_records_total{level=...}``): warn/error rates become
    scrapeable metrics next to the counters they explain. Always
    resolves the current default registry, so `telemetry.reset_registry`
    (test isolation) is honored."""

    def emit(self, record):
        try:
            from aclswarm_torch.telemetry import get_registry
            get_registry().counter(
                "log_records_total",
                labels={"level": record.levelname.lower()}).inc()
        except Exception:       # noqa: BLE001 — logging must never raise
            pass


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(_TtyFormatter(
            "[%(levelname).1s %(asctime)s %(name)s] %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(handler)
    if not any(isinstance(h, _TelemetryHandler) for h in root.handlers):
        root.addHandler(_TelemetryHandler())
    root.setLevel(logging.INFO)
    # ACLSWARM_LOG=debug  or  ACLSWARM_LOG=<logger>=<level>,<logger>=...
    spec = os.environ.get("ACLSWARM_LOG", "")
    for part in filter(None, (s.strip() for s in spec.split(","))):
        if "=" in part:
            name, _, level = part.partition("=")
            logging.getLogger(name).setLevel(level.upper())
        else:
            root.setLevel(part.upper())


def get_logger(name: str = ROOT) -> logging.Logger:
    """A child of the framework root logger (configured on first use)."""
    _configure()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
