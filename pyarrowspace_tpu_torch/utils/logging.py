"""Leveled, module-tagged engine logging.

Equivalent of the reference engine's `log` + `env_logger` (RUST_LOG) stack
(reference Cargo.lock; observed lines like
"DEBUG arrowspace::builder: Build configuration: ..." in
tests/output/1760705545_v0_16/suggested_eps.md:3-10).  Controlled by the
ARROWSPACE_LOG env var with the same level vocabulary
(error|warn|info|debug|trace), e.g. ARROWSPACE_LOG=debug.

This is the engine-internal channel; the user-facing `set_debug`
`[pyarrowspace] ...` stderr lines (utils/debug.py) are a separate toggle,
matching the reference's two-level design (SURVEY.md §5).
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "arrowspace"
_LEVELS = {"error": logging.ERROR, "warn": logging.WARNING,
           "info": logging.INFO, "debug": logging.DEBUG, "trace": 5}
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    logging.addLevelName(5, "TRACE")
    level_name = os.environ.get("ARROWSPACE_LOG", "warn").lower()
    level = _LEVELS.get(level_name, logging.WARNING)
    logger = logging.getLogger(_ROOT)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
    logger.propagate = False


def get_logger(module: str) -> logging.Logger:
    """Module-tagged logger, e.g. get_logger('builder') ->
    'arrowspace::builder'-style records."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{module}")
