"""Configuration subsystem: defaults, YAML loader, language registry.

Own copy of ``stt_tpu/config/__init__.py`` for the port, which imports nothing of ``stt_tpu``.
"""

from .defaults import (  # noqa: F401
    ALLOWED_DECODE_OPTION_KEYS,
    DEFAULT_DECODE_PROFILE,
    DEFAULT_DECODE_PROFILE_NAME,
    DEFAULT_MODEL_ID,
    MODEL_SECTION_MAP,
    SERVER_SECTION_MAP,
    default_decode_profiles,
)
from .languages import SupportedLanguages  # noqa: F401
from .loader import (  # noqa: F401
    DEFAULT_CONFIG_PATH,
    DEFAULT_MODEL_CONFIG_PATH,
    SECTION_MAP,
    ServerConfig,
    ensure_default_model_load_profile,
    load_config,
    parse_mesh_shape,
)
