"""Core library (port of ``repro.core``): the slice of the paper's
contribution that runs one Algorithm-2 scenario sweep end to end."""
from repro_torch.core.types import AuctionRule, SimResult, never_capped
from repro_torch.core.auction import (resolve, resolve_row, spend_sums,
                                      spend_matrix)
from repro_torch.core.sequential import sequential_replay, capped_sum
from repro_torch.core.segments import (REDUCE_BLOCKS, fold_blocks,
                                       partial_spend_sums)
from repro_torch.core.executor import SweepPlan, execute_sweep, pick_resolve
from repro_torch.core.sweep import (sweep_sequential, sweep_parallel,
                                    sweep_state_machine, stack_rules,
                                    scenario_rule)
from repro_torch.core.counterfactual import (CounterfactualEngine,
                                             ScenarioGrid, SweepResult)

__all__ = [
    "AuctionRule", "SimResult", "never_capped",
    "resolve", "resolve_row", "spend_sums", "spend_matrix",
    "sequential_replay", "capped_sum",
    "REDUCE_BLOCKS", "fold_blocks", "partial_spend_sums",
    "SweepPlan", "execute_sweep", "pick_resolve",
    "sweep_sequential", "sweep_parallel", "sweep_state_machine",
    "stack_rules", "scenario_rule",
    "CounterfactualEngine", "ScenarioGrid", "SweepResult",
]
