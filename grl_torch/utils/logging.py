"""Console + file logging.

Replaces the reference's colorlog-based logger with three rotating file
sinks (reference: gnn/utils/logger/color_logger.py:8-59) using stdlib
logging: colored console (ANSI, no external deps) plus per-severity file
sinks under ``$OUTPUT_DIR`` when set.
"""
from __future__ import annotations

import logging
import os
import sys
from logging.handlers import RotatingFileHandler

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{base}{_RESET}"
        return base


_CONFIGURED: set = set()


def get_logger(name: str, output_dir: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _CONFIGURED:
        return logger
    _CONFIGURED.add(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False

    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(
        _ColorFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    )
    logger.addHandler(console)

    output_dir = output_dir or os.environ.get("OUTPUT_DIR")
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        for suffix, level in (
            ("output.log", logging.INFO),
            ("output.warning.log", logging.WARNING),
            ("output.error.log", logging.ERROR),
        ):
            handler = RotatingFileHandler(
                os.path.join(output_dir, suffix), maxBytes=5_000_000, backupCount=2
            )
            handler.setLevel(level)
            handler.setFormatter(fmt)
            logger.addHandler(handler)
    return logger
