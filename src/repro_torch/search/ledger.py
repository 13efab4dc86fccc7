"""Explicit accounting of scenario evaluations against a search budget
(port of ``repro.search.ledger``; pure Python).

Every optimizer charges the ledger BEFORE running a sweep batch, and the
ledger refuses a charge that would exceed the budget — so a search can
never silently over-spend scenario evaluations: either the batch fits and
``spent`` grows by exactly its size, or :class:`BudgetExhausted` is raised
and no sweep runs. ``entries`` keeps the full charge trail, making
``spent == sum(n for _, n in entries)`` an auditable invariant (asserted
in tests/test_torch_search.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


class BudgetExhausted(RuntimeError):
    """Charging this batch would exceed the evaluation budget."""


@dataclasses.dataclass
class EvaluationLedger:
    """Counts scenario evaluations (sweep lanes) against a hard budget."""

    budget: int
    spent: int = 0
    entries: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.budget < 1:
            raise ValueError(
                f"evaluation budget must be >= 1, got {self.budget}")

    @property
    def remaining(self) -> int:
        return self.budget - self.spent

    def affordable(self, n: int) -> bool:
        return self.spent + n <= self.budget

    def charge(self, n: int, note: str = "") -> None:
        """Record ``n`` scenario evaluations, refusing any over-spend."""
        if n < 1:
            raise ValueError(f"cannot charge {n} evaluations")
        if not self.affordable(n):
            raise BudgetExhausted(
                f"evaluation budget exhausted: charging {n} scenario "
                f"evaluations would spend {self.spent + n} of "
                f"{self.budget} ({note or 'unlabelled batch'})")
        self.spent += n
        self.entries.append((note, int(n)))
