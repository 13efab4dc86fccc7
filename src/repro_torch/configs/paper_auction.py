"""The paper's synthetic experiment configurations (§7.1), as named presets
(a copy of ``repro.configs.paper_auction:13-28``; the port imports nothing
of ``repro``).

``PAPER_SYNTHETIC_FULL`` is §7.1 exactly as published; ``PAPER_SYNTHETIC_CPU``
keeps its structure at a size a CPU replays in seconds, with ``b_base``
calibrated to a ~50% cap rate.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SyntheticPreset:
    n_events: int
    n_campaigns: int
    emb_dim: int
    b_base: float | None


# §7.1 exactly as published
PAPER_SYNTHETIC_FULL = SyntheticPreset(
    n_events=1_000_000, n_campaigns=100, emb_dim=10, b_base=70.0)

# same structure, calibrated ~50% cap rate
PAPER_SYNTHETIC_CPU = SyntheticPreset(
    n_events=65_536, n_campaigns=64, emb_dim=10, b_base=None)
