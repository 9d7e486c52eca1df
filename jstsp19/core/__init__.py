from jstsp19.core.config import SystemConfig, canonical_system  # noqa: F401
from jstsp19.core.metrics import nmse, clamped_nmse  # noqa: F401
