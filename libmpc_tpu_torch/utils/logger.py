"""Host-side logging with the reference's level semantics.

Mirrors the singleton ``Logger`` (reference: include/mpc/Logger.hpp:27-216):
three message types (DETAIL/INFO/ERROR) filtered by four threshold levels
(DEEP/NORMAL/ALERT/NONE), an env-var override ``MPCXX_LOG_LEVEL_OVERRIDE``,
stream redirection and a ``[MPC++ <prefix>]`` line prefix.  It is a
host-side component, restated from ``libmpc_tpu/utils/logger.py``.
"""

from __future__ import annotations

import enum
import os
import sys
import threading
from typing import Optional, TextIO


class LogType(enum.IntEnum):
    DETAIL = 0
    INFO = 1
    ERROR = 2


class LogLevel(enum.IntEnum):
    DEEP = 0  # everything
    NORMAL = 1  # info + errors
    ALERT = 2  # errors only
    NONE = 3  # nothing


# message type -> minimum level at which it is still printed
_TYPE_MAX_LEVEL = {
    LogType.DETAIL: LogLevel.DEEP,
    LogType.INFO: LogLevel.NORMAL,
    LogType.ERROR: LogLevel.ALERT,
}

_ENV_OVERRIDE = "MPCXX_LOG_LEVEL_OVERRIDE"


class Logger:
    """Process-wide singleton logger (reference: include/mpc/Logger.hpp:46-76)."""

    _instance: Optional["Logger"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._level = LogLevel.NONE
        self._prefix = ""
        self._stream: TextIO = sys.stdout
        self._apply_env_override()

    @classmethod
    def instance(cls) -> "Logger":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Logger()
            return cls._instance

    @classmethod
    def _reset_for_tests(cls):
        with cls._lock:
            cls._instance = None

    def _apply_env_override(self):
        value = os.environ.get(_ENV_OVERRIDE)
        if not value:
            return
        try:
            self._level = LogLevel[value.strip().upper()]
        except KeyError:
            pass  # invalid override is ignored like the reference

    # -- configuration ---------------------------------------------------
    def set_level(self, level: LogLevel) -> "Logger":
        if os.environ.get(_ENV_OVERRIDE):
            self._apply_env_override()
        else:
            self._level = LogLevel(level)
        return self

    def set_prefix(self, prefix: str) -> "Logger":
        self._prefix = prefix
        return self

    def set_stream(self, stream: TextIO) -> "Logger":
        self._stream = stream
        return self

    def reset(self) -> "Logger":
        self._level = LogLevel.NONE
        self._prefix = ""
        self._stream = sys.stdout
        self._apply_env_override()
        return self

    @property
    def level(self) -> LogLevel:
        return self._level

    # -- emission --------------------------------------------------------
    def _enabled(self, log_type: LogType) -> bool:
        return self._level <= _TYPE_MAX_LEVEL[LogType(log_type)]

    def log(self, log_type: LogType, message: str) -> None:
        if not self._enabled(log_type):
            return
        prefix = f"[MPC++ {self._prefix}] " if self._prefix else "[MPC++] "
        self._stream.write(prefix + message.rstrip("\n") + "\n")

    def detail(self, message: str) -> None:
        self.log(LogType.DETAIL, message)

    def info(self, message: str) -> None:
        self.log(LogType.INFO, message)

    def error(self, message: str) -> None:
        self.log(LogType.ERROR, message)
