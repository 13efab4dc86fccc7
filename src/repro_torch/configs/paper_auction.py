"""The paper's experiment configurations (§7.1 and §7.2), as named presets
(a copy of ``repro.configs.paper_auction:13-48``; the port imports nothing
of ``repro``).

``PAPER_SYNTHETIC_FULL`` is §7.1 exactly as published; ``PAPER_SYNTHETIC_CPU``
keeps its structure at a size a CPU replays in seconds, with ``b_base``
calibrated to a ~50% cap rate. ``PAPER_YAHOO_FULL`` is §7.2's Yahoo-like
day pair (1,000 keywords, 200 advertisers, 100,000 then 150,000 auctions,
budget 2,000); ``PAPER_YAHOO_CPU`` the same landscape at a CPU's size.
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


@dataclasses.dataclass(frozen=True)
class YahooPreset:
    n_keywords: int
    n_campaigns: int
    n_day1: int
    n_day2: int
    budget: float


# §7.2: ~1000 keywords, volume 100k -> 150k, constant budget 2000
PAPER_YAHOO_FULL = YahooPreset(
    n_keywords=1000, n_campaigns=200, n_day1=100_000, n_day2=150_000,
    budget=2000.0)

PAPER_YAHOO_CPU = YahooPreset(
    n_keywords=1000, n_campaigns=100, n_day1=32_768, n_day2=49_152,
    budget=120.0)
