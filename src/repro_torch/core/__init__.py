"""Core library (port of ``repro.core``): Algorithm 2 for one design and
for a scenario sweep, and the exact sequential oracle."""
from repro_torch.core.types import (AuctionRule, Segments, SimResult,
                                    never_capped)
from repro_torch.core.auction import (resolve, resolve_row, spend_sums,
                                      spend_matrix)
from repro_torch.core.sequential import sequential_replay, capped_sum
from repro_torch.core.segments import (REDUCE_BLOCKS, block_spend_sums,
                                       fold_blocks, masked_rate,
                                       partial_spend_sums, window_partials)
from repro_torch.core.executor import SweepPlan, execute_sweep, pick_resolve
from repro_torch.core.parallel import (ParallelSimTrace, parallel_simulate,
                                       parallel_state_machine)
from repro_torch.core.sweep import (sweep_sequential, sweep_parallel,
                                    sweep_state_machine, stack_rules,
                                    scenario_rule)
from repro_torch.core.counterfactual import (CounterfactualEngine,
                                             ScenarioGrid, SweepResult)

__all__ = [
    "AuctionRule", "Segments", "SimResult", "never_capped",
    "resolve", "resolve_row", "spend_sums", "spend_matrix",
    "sequential_replay", "capped_sum",
    "REDUCE_BLOCKS", "fold_blocks", "partial_spend_sums", "window_partials",
    "masked_rate", "block_spend_sums",
    "SweepPlan", "execute_sweep", "pick_resolve",
    "ParallelSimTrace", "parallel_simulate", "parallel_state_machine",
    "sweep_sequential", "sweep_parallel", "sweep_state_machine",
    "stack_rules", "scenario_rule",
    "CounterfactualEngine", "ScenarioGrid", "SweepResult",
]
