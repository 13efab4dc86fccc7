"""Core library (port of ``repro.core``): SORT2AGGREGATE with Algorithm 4,
Algorithm 2 for one design and for a scenario sweep (over event and
scenario chunks too, from a log in host memory, as resumable folds of a
growing log, and on a mesh of devices or processes), the exact sequential
oracle and the naive sampled replay; :mod:`.theory`, :mod:`.multislot`
and the rest of :mod:`.sharded` are imported by name."""
from repro_torch.core.types import (AuctionRule, Segments, SimResult,
                                    never_capped)
from repro_torch.core.auction import (resolve, resolve_row, spend_sums,
                                      spend_matrix)
from repro_torch.core.sequential import (capped_sum, naive_sampled_replay,
                                         sequential_replay)
from repro_torch.core.segments import (REDUCE_BLOCKS, aggregate,
                                       block_spend_sums,
                                       first_crossing_times, fold_blocks,
                                       masked_rate, partial_spend_sums,
                                       window_partials)
from repro_torch.core.executor import (ChunkSpec, HostStream,
                                       ScenarioChunkSpec, SweepCarry,
                                       SweepPlan, check_s2a_options,
                                       execute_s2a_sweep, execute_sweep,
                                       execute_sweep_resumable,
                                       initial_carry, pick_resolve)
from repro_torch.core.metrics import (cap_time_error, relative_error,
                                      relative_error_cdf,
                                      spend_weighted_relative_error)
from repro_torch.core.sort2aggregate import (Sort2AggregateResult,
                                             refine_fixed_chunked,
                                             refine_fixed_device,
                                             refine_segments, sort2aggregate)
from repro_torch.core.vi import (PiEstimate, capping_order, estimate_pi,
                                 estimate_pi_sweep, pi_to_cap_times)
from repro_torch.core.parallel import (ParallelSimTrace, parallel_simulate,
                                       parallel_state_machine)
from repro_torch.core.sweep import (sweep_sequential, sweep_parallel,
                                    sweep_sort2aggregate,
                                    sweep_state_machine, stack_rules,
                                    scenario_rule)
from repro_torch.core.sharded import (sweep_first_crossing_sharded,
                                      sweep_sharded,
                                      sweep_sort2aggregate_sharded)
from repro_torch.core.counterfactual import (CounterfactualDelta,
                                             CounterfactualEngine,
                                             ScenarioGrid, SweepResult)

__all__ = [
    "AuctionRule", "Segments", "SimResult", "never_capped",
    "resolve", "resolve_row", "spend_sums", "spend_matrix",
    "sequential_replay", "naive_sampled_replay", "capped_sum",
    "REDUCE_BLOCKS", "fold_blocks", "partial_spend_sums", "window_partials",
    "masked_rate", "block_spend_sums", "aggregate", "first_crossing_times",
    "SweepPlan", "ChunkSpec", "ScenarioChunkSpec", "execute_sweep",
    "pick_resolve", "check_s2a_options", "HostStream", "SweepCarry",
    "initial_carry", "execute_sweep_resumable",
    "execute_s2a_sweep",
    "relative_error", "spend_weighted_relative_error", "relative_error_cdf",
    "cap_time_error",
    "PiEstimate", "pi_to_cap_times", "capping_order", "estimate_pi",
    "estimate_pi_sweep",
    "Sort2AggregateResult", "refine_segments", "refine_fixed_device",
    "refine_fixed_chunked",
    "sort2aggregate",
    "ParallelSimTrace", "parallel_simulate", "parallel_state_machine",
    "sweep_sequential", "sweep_parallel", "sweep_sort2aggregate",
    "sweep_state_machine", "stack_rules", "scenario_rule",
    "sweep_sharded", "sweep_sort2aggregate_sharded",
    "sweep_first_crossing_sharded",
    "CounterfactualDelta", "CounterfactualEngine", "ScenarioGrid",
    "SweepResult",
]
