"""Stdlib logging for the runner's output.

The port of `repro.obs.log`: the human-facing lines go through one
`repro_torch` logger hierarchy, so severities separate:

  * progress chatter -> INFO  (hidden by `--quiet`)
  * debug detail     -> DEBUG (shown by `-v`)
  * health alarms    -> WARNING, prefixed `WARNING:` — visible even
                        under `--quiet`

The machine-readable output (`run_fl`'s final JSON) stays on plain
stdout.

    from repro_torch.obs.log import configure_logging, get_logger
    log = get_logger(__name__)
    configure_logging(verbosity=args.verbose, quiet=args.quiet)
    log.warning("flat-battery: %d devices below reserve", n)
"""
from __future__ import annotations

import logging
import sys
from typing import Optional

ROOT_LOGGER = "repro_torch"
_configured = False


class _LevelPrefixFormatter(logging.Formatter):
    """INFO/DEBUG lines print bare; WARNING and above keep their level
    prefix so alarms stand out."""

    def format(self, record: logging.LogRecord) -> str:
        msg = record.getMessage()
        if record.levelno >= logging.WARNING:
            return f"{record.levelname}: {msg}"
        return msg


class _StderrHandler(logging.StreamHandler):
    """Writes to whatever `sys.stderr` is when a record is emitted, not
    the stream of the moment the handler was made (which a test's
    capture may have closed since)."""

    def __init__(self):
        super().__init__(sys.stderr)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _):
        pass


def configure_logging(verbosity: int = 0, quiet: bool = False,
                      stream=None) -> logging.Logger:
    """(Re)configure the `repro_torch` logger: WARNING under `quiet`,
    DEBUG at verbosity >= 1, INFO otherwise. Idempotent: replaces the one
    stream handler instead of stacking duplicates. Without `stream` it
    writes to the current `sys.stderr`."""
    global _configured
    root = logging.getLogger(ROOT_LOGGER)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = (logging.StreamHandler(stream) if stream is not None
               else _StderrHandler())
    handler.setFormatter(_LevelPrefixFormatter())
    root.addHandler(handler)
    root.propagate = False
    root.setLevel(logging.WARNING if quiet
                  else logging.DEBUG if verbosity >= 1 else logging.INFO)
    _configured = True
    return root


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Child of the `repro_torch` logger (configured at INFO on first
    use)."""
    if not _configured:
        configure_logging()
    if not name or name == ROOT_LOGGER:
        return logging.getLogger(ROOT_LOGGER)
    if name.startswith(ROOT_LOGGER + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{ROOT_LOGGER}.{name}")
