"""Supported-language registry backed by a CSV data file.

Own copy of ``stt_tpu/config/languages.py`` for the port, which imports nothing of ``stt_tpu``.

Whisper's 100-language inventory (99 languages + Cantonese alias) lives in
``stt_tpu_torch/config/data/supported_languages.csv``; codes are validated at
CreateSession time (reference: ``stt_server/config/languages.py:11-59``).
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Dict, Optional, Set

LOGGER = logging.getLogger("stt_tpu_torch")

_CSV_PATH = Path(__file__).resolve().parent / "data" / "supported_languages.csv"


class SupportedLanguages:
    """Lazily loads and caches code -> display-name mappings."""

    def __init__(self, csv_path: Optional[Path] = None) -> None:
        self._csv_path = csv_path or _CSV_PATH
        self._language_map: Optional[Dict[str, str]] = None

    def _ensure_loaded(self) -> Dict[str, str]:
        if self._language_map is None:
            self._language_map = self._load()
        return self._language_map

    def get_codes(self) -> Optional[Set[str]]:
        """All supported codes, or None if the data file is unavailable."""
        mapping = self._ensure_loaded()
        return set(mapping) if mapping else None

    def get_name(self, code: str) -> str:
        """Display name for a code ('' when unknown or empty)."""
        if not code:
            return ""
        return self._ensure_loaded().get(code.lower(), "")

    def _load(self) -> Dict[str, str]:
        try:
            with self._csv_path.open("r", encoding="utf-8") as fh:
                reader = csv.DictReader(fh)
                mapping: Dict[str, str] = {}
                for row in reader:
                    code = row.get("Language Code") or row.get("language_code")
                    name = row.get("Language Name") or row.get("language_name")
                    if code:
                        mapping[code.strip().lower()] = (name or "").strip()
                return mapping
        except FileNotFoundError:
            LOGGER.warning(
                "supported_languages.csv missing at %s; language validation disabled",
                self._csv_path,
            )
            return {}


__all__ = ["SupportedLanguages"]
