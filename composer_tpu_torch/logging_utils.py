"""Colourized logging: the port's copy of ``composer_tpu/logging_utils.py``
(parity: composer/logging_utils.py:6-52).

INFO records render as the bare message; every other level renders as
``LEVEL: message`` with the level name colourized. The colours are the ANSI
escape codes that ``colorama``'s ``Fore`` constants hold; the port writes
them itself, so it does not need ``colorama``.
"""

from __future__ import annotations

import copy
import logging

_RESET = "\x1b[0m"
_LEVEL_COLOURS = {
    logging.FATAL: "\x1b[91m",  # light red
    logging.ERROR: "\x1b[31m",  # red
    logging.WARNING: "\x1b[33m",  # yellow
    logging.DEBUG: "\x1b[97m",  # light white
}

_DEFAULT_FORMAT = "%(levelname)s: %(message)s"
_INFO_FORMAT = "%(message)s"


def colourize_string(string: str, colour: str) -> str:
    return f"{colour}{string}{_RESET}"


class _ColourFormatter(logging.Formatter):
    def format(self, record, *args, **kwargs):
        record = copy.copy(record)
        if record.levelno in _LEVEL_COLOURS:
            record.levelname = colourize_string(record.levelname, _LEVEL_COLOURS[record.levelno])

        fmt = _INFO_FORMAT if record.levelno == logging.INFO else _DEFAULT_FORMAT
        original = self._style._fmt
        self._style._fmt = fmt
        try:
            return super().format(record, *args, **kwargs)
        finally:
            self._style._fmt = original


def init() -> None:
    """Installs the colourized handler on the root logger (idempotent)."""
    root = logging.getLogger()
    for handler in root.handlers:
        if isinstance(getattr(handler, "formatter", None), _ColourFormatter):
            return
    handler = logging.StreamHandler()
    handler.setFormatter(_ColourFormatter(_DEFAULT_FORMAT))
    root.addHandler(handler)


def set_verbosity(level_name: str) -> None:
    level = getattr(logging, level_name.upper(), None)
    if level is None:
        raise ValueError(
            f"Must be CRITICAL, ERROR, WARNING, INFO, or DEBUG, not '{level_name}'"
        )
    logging.getLogger().setLevel(level)
