"""Structured logging configuration (ray analog:
python/ray/_private/ray_logging/logging_config.py:74 `LoggingConfig`).

Redesigned small: instead of the reference's dictConfig provider registry,
the config is two fields applied to the driver's `ray_tpu_torch` loggers at
`init(logging_config=...)` and exported through the environment
(`RAY_TPU_TORCH_LOG_ENCODING` / `RAY_TPU_TORCH_LOG_LEVEL`) so controller, agents, and
every worker process format their session logs the same
way.  Encoding "JSON" emits one JSON object per line with the fields the
reference's structured encoding carries (asctime/levelname/message plus
logger name); "TEXT" keeps the human format.
"""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass

_ENCODINGS = ("TEXT", "JSON")
TEXT_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "asctime": self.formatTime(record),
            "levelname": record.levelname,
            "name": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exc_text"] = self.formatException(record.exc_info)
        return json.dumps(out)


@dataclass
class LoggingConfig:
    encoding: str = "TEXT"
    log_level: str = "INFO"

    def __post_init__(self):
        if self.encoding not in _ENCODINGS:
            raise ValueError(
                f"Invalid encoding type: {self.encoding}. "
                f"Valid encoding types are: {list(_ENCODINGS)}")
        self.log_level = self.log_level.upper()
        if self.log_level not in logging._nameToLevel:
            raise ValueError(f"Invalid log level: {self.log_level}")

    def apply(self) -> None:
        """Configure the current process's root logger handlers."""
        configure_process_logging(self.encoding, self.log_level)

    def env(self) -> dict[str, str]:
        """Env vars that propagate this config to spawned processes."""
        return {"RAY_TPU_TORCH_LOG_ENCODING": self.encoding,
                "RAY_TPU_TORCH_LOG_LEVEL": self.log_level}


def configure_process_logging(encoding: str | None = None,
                              level: str | None = None) -> None:
    """Apply encoding/level (args override env) to the root logger —
    shared by worker_main/controller/agent startup.  NO-OP when neither
    an argument nor an env var is present: each runtime process sets its
    own role-tagged format ("... controller: ...", "worker[pid]: ...")
    that must survive an unconfigured run."""
    import os

    if encoding is None and level is None \
            and "RAY_TPU_TORCH_LOG_ENCODING" not in os.environ \
            and "RAY_TPU_TORCH_LOG_LEVEL" not in os.environ:
        return
    encoding = encoding or os.environ.get("RAY_TPU_TORCH_LOG_ENCODING", "TEXT")
    level = level or os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO")
    root = logging.getLogger()
    root.setLevel(level)
    if not root.handlers:
        root.addHandler(logging.StreamHandler())
    fmt = (JsonFormatter() if encoding == "JSON"
           else logging.Formatter(TEXT_FORMAT))
    for h in root.handlers:
        h.setFormatter(fmt)
