"""LM serving (port of ``repro.serve.engine``)."""
from repro_torch.serve.engine import (RequestBatch, ServeEngine, ServePlan,
                                      estimate_exit_steps, plan_compactions,
                                      wasted_slot_steps)

__all__ = ["ServeEngine", "RequestBatch", "ServePlan", "estimate_exit_steps",
           "plan_compactions", "wasted_slot_steps"]
