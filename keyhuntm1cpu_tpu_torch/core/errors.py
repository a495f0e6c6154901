"""Error hierarchy of the port: a copy of the classes of
keyhuntm1cpu_tpu/core/errors.py that the port raises or catches."""

from __future__ import annotations


class KeyhuntError(Exception):
    """Base class for all framework errors."""

    category = "general"


class ConfigError(KeyhuntError):
    """Bad flag / config-file / parameter combination."""

    category = "config"


class ValidationError(KeyhuntError):
    """Bad user input: malformed address / hex / range / path."""

    category = "validation"


class CheckpointError(KeyhuntError):
    """Corrupt or mismatched checkpoint file."""

    category = "checkpoint"
