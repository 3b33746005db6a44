"""Colored stream logging, compatible with the reference's log contract.

Same logger name (``muse_psfr``) and format (``[%(levelname)s]
%(message)s``) as ``muse_psfr_tpu/utils/log.py``: the reference's tests
assert on exact INFO message sequences through that logger.
"""

import logging
import sys

LOGGER_NAME = "muse_psfr"

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[1;31m",
}
_RESET = "\x1b[0m"


class ColoredFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno)
        if color and sys.stdout.isatty():
            return color + msg + _RESET
        return msg


def setup_logging(name=LOGGER_NAME, fmt="[%(levelname)s] %(message)s",
                  level="INFO", stream=None):
    """Install a single stream handler on ``name`` (idempotent)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(stream or sys.stdout)
        handler.setFormatter(ColoredFormatter(fmt))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def get_logger(suffix=None):
    name = LOGGER_NAME if not suffix else LOGGER_NAME + "." + suffix
    return logging.getLogger(name)
