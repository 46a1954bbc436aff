"""Decode-profile, language, and task resolution.

Own copy of ``stt_tpu/server/application/profile_resolver.py`` for the port, which imports nothing of ``stt_tpu``.

Wire-behavior parity with the reference resolvers (``stt_server/backend/
utils/profile_resolver.py:14-97``): unknown profiles fall back to the default,
unsupported language codes resolve to "" (auto), task enums map to names with
a configured default, and per-session decode options are whitelist-checked
(ERR1010 upstream).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ...config import ALLOWED_DECODE_OPTION_KEYS, default_decode_profiles
from ...config.languages import SupportedLanguages
from ...gen import stt_pb2

PROFILE_ENUM_TO_NAME = {
    stt_pb2.DECODE_PROFILE_REALTIME: "realtime",
    stt_pb2.DECODE_PROFILE_ACCURATE: "accurate",
}
PROFILE_NAME_TO_ENUM = {v: k for k, v in PROFILE_ENUM_TO_NAME.items()}
TASK_ENUM_TO_NAME = {
    stt_pb2.TASK_TRANSCRIBE: "transcribe",
    stt_pb2.TASK_TRANSLATE: "translate",
}
TASK_NAME_TO_ENUM = {v: k for k, v in TASK_ENUM_TO_NAME.items()}


def normalize_decode_profiles(
    raw: Optional[Dict[str, Dict[str, Any]]],
) -> Dict[str, Dict[str, Any]]:
    profiles = {
        name: dict(options)
        for name, options in (raw or {}).items()
        if isinstance(options, dict)
    }
    return profiles or default_decode_profiles()


def resolve_decode_profile(
    requested: Optional[str],
    profiles: Dict[str, Dict[str, Any]],
    default_profile: str,
) -> Tuple[str, Dict[str, Any]]:
    if requested and requested in profiles:
        return requested, dict(profiles[requested])
    if default_profile in profiles:
        return default_profile, dict(profiles[default_profile])
    # misconfigured default: fall back to built-ins rather than crash
    fallback = default_decode_profiles()
    name = default_profile if default_profile in fallback else "realtime"
    return name, dict(fallback.get(name, {}))


def invalid_decode_options(options: Dict[str, Any]) -> List[str]:
    return [k for k in options if k not in ALLOWED_DECODE_OPTION_KEYS]


def resolve_language_code(
    requested: str,
    default_language: str,
    language_fix: bool,
    supported: SupportedLanguages,
) -> str:
    trimmed = requested.strip().lower() if requested else ""
    codes = supported.get_codes()
    if trimmed:
        if codes is not None and trimmed not in codes:
            return ""
        return trimmed
    if language_fix and default_language:
        if codes is not None and default_language not in codes:
            return ""
        return default_language
    return ""


def resolve_task(requested: int, default_task: str) -> str:
    return TASK_ENUM_TO_NAME.get(requested, default_task)


def task_enum_from_name(name: str) -> int:
    return TASK_NAME_TO_ENUM.get(name or "", stt_pb2.TASK_TRANSCRIBE)


def profile_name_from_enum(profile_enum: int) -> Optional[str]:
    return PROFILE_ENUM_TO_NAME.get(profile_enum)


def profile_enum_from_name(name: str) -> int:
    return PROFILE_NAME_TO_ENUM.get(name or "", stt_pb2.DECODE_PROFILE_UNSPECIFIED)


__all__ = [
    "invalid_decode_options",
    "normalize_decode_profiles",
    "profile_enum_from_name",
    "profile_name_from_enum",
    "resolve_decode_profile",
    "resolve_language_code",
    "resolve_task",
    "task_enum_from_name",
]
