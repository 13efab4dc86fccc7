"""The search domain: box bounds over the ScenarioGrid design axes (port of
``repro.search.space``; pure Python).

A :class:`SearchSpace` bounds any subset of the three
:meth:`~repro_torch.core.counterfactual.ScenarioGrid.product` axes — ``bid_scale``
(multiplies every campaign's bid multiplier), ``reserve`` (the auction
reserve price), ``budget_scale`` (scales every campaign's budget) — plus
per-campaign ``boost[c]`` axes declared via ``campaign_boost`` (campaign ``c``'s
individual multiplier scaling, the search-side face of
``repro``'s ``scenarios.BoostCampaign``). A *point* is a plain
``{axis: float}`` dict over the bounded axes; axes left unbounded stay at
the engine's base design. A *box* is a ``{axis: (lo, hi)}`` dict — the
optimizers shrink boxes, the space clips them to its bounds.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

SEARCH_AXES = ("bid_scale", "reserve", "budget_scale")

Point = Dict[str, float]
Box = Dict[str, Tuple[float, float]]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Box bounds over the scenario-design axes (``None`` = not searched).

    ``campaign_boost`` maps campaign indices to ``(lo, hi)`` bounds for that
    campaign's ``boost[c]`` axis — a dict or a sequence of ``(c, (lo, hi))``
    pairs, normalized to a sorted tuple so the space stays hashable.
    """

    bid_scale: Optional[Tuple[float, float]] = None
    reserve: Optional[Tuple[float, float]] = None
    budget_scale: Optional[Tuple[float, float]] = None
    campaign_boost: Optional[Tuple] = None

    def __post_init__(self):
        if self.campaign_boost is not None:
            items = (self.campaign_boost.items()
                     if isinstance(self.campaign_boost, dict)
                     else self.campaign_boost)
            norm = tuple(sorted(
                (int(c), (float(lo), float(hi))) for c, (lo, hi) in items))
            if len({c for c, _ in norm}) != len(norm):
                raise ValueError(
                    "campaign_boost bounds the same campaign twice")
            object.__setattr__(self, "campaign_boost", norm or None)
        if not self.axes:
            raise ValueError(
                "SearchSpace needs at least one bounded axis; give (lo, hi) "
                f"bounds for one of {SEARCH_AXES} or a campaign_boost entry")
        for a in self.axes:
            lo, hi = self._bounds_of(a)
            if not (lo <= hi):
                raise ValueError(f"SearchSpace.{a}: lo={lo} > hi={hi}")

    def _bounds_of(self, axis: str) -> Tuple[float, float]:
        if axis in SEARCH_AXES:
            b = getattr(self, axis)
            if b is None:
                raise KeyError(f"axis {axis!r} is not bounded")
            return b
        if axis.startswith("boost[") and axis.endswith("]"):
            c = int(axis[6:-1])
            for cc, b in (self.campaign_boost or ()):
                if cc == c:
                    return b
        raise KeyError(f"axis {axis!r} is not bounded by this space")

    @property
    def axes(self) -> Tuple[str, ...]:
        base = tuple(a for a in SEARCH_AXES if getattr(self, a) is not None)
        boost = tuple(f"boost[{c}]" for c, _ in (self.campaign_boost or ()))
        return base + boost

    def bounds(self) -> Box:
        return {a: tuple(map(float, self._bounds_of(a))) for a in self.axes}

    def widths(self, box: Optional[Box] = None) -> Dict[str, float]:
        box = self.bounds() if box is None else box
        return {a: hi - lo for a, (lo, hi) in box.items()}

    def center(self, box: Optional[Box] = None) -> Point:
        box = self.bounds() if box is None else box
        return {a: 0.5 * (lo + hi) for a, (lo, hi) in box.items()}

    def clip(self, point: Point) -> Point:
        out = {}
        for a in self.axes:
            lo, hi = self._bounds_of(a)
            out[a] = min(max(float(point.get(a, 0.5 * (lo + hi))), lo), hi)
        return out

    def grid(self, num: int, box: Optional[Box] = None) -> List[Point]:
        """A balanced cartesian grid of ~``num`` points over ``box``.

        Per-axis counts are the largest k with ``k**d <= num`` (at least 2),
        so 1-D boxes get exactly ``num`` points and multi-axis boxes the
        nearest cartesian product not exceeding ``num``. Endpoints
        inclusive; a zero-width axis contributes its single value.
        """
        if num < 1:
            raise ValueError(f"grid needs num >= 1, got {num}")
        box = self.bounds() if box is None else box
        d = len(box)
        k = max(2, int(num ** (1.0 / d))) if num >= 2 ** d else 2
        while k ** d > num and k > 2:
            k -= 1
        if d == 1:
            k = max(2, num)
        per_axis = []
        for a, (lo, hi) in box.items():
            if hi == lo:
                per_axis.append([lo])
            else:
                per_axis.append([lo + (hi - lo) * i / (k - 1)
                                 for i in range(k)])
        return [dict(zip(box.keys(), combo))
                for combo in itertools.product(*per_axis)]

    def shrink_around(self, point: Point, factor: float,
                      box: Optional[Box] = None) -> Box:
        """A ``factor``-width sub-box centered on ``point``, clipped to the
        space bounds (the center slides inward at an edge, so the new box
        always has the full shrunk width where the space allows it)."""
        box = self.bounds() if box is None else box
        out = {}
        for a, (lo, hi) in box.items():
            s_lo, s_hi = self._bounds_of(a)
            half = 0.5 * (hi - lo) * factor
            c = min(max(float(point[a]), s_lo + half), s_hi - half) \
                if s_hi - s_lo >= 2 * half else 0.5 * (s_lo + s_hi)
            out[a] = (max(c - half, s_lo), min(c + half, s_hi))
        return out
