"""Config helpers shared by the launcher. The port's own copy of the part
of `repro/configs/base.py` it uses (`mib_to_bytes`); the model configs
there arrive with the language-model substrate."""
from __future__ import annotations

from typing import Optional


def mib_to_bytes(mb: Optional[float]) -> Optional[int]:
    """CLI-facing memory budgets (`--max-resident-mb` style knobs) -> byte
    counts for config fields like `NeRFConfig.max_resident_bytes`.
    None/0/negative mean "unlimited" and map to None."""
    if not mb or mb <= 0:
        return None
    return int(mb * 1024 * 1024)
