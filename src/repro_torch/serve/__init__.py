"""LM serving (port of ``repro.serve.engine``) and the always-on
counterfactual service (port of ``repro.serve.counterfactual``)."""
from repro_torch.serve.engine import (RequestBatch, ServeEngine, ServePlan,
                                      estimate_exit_steps, plan_compactions,
                                      wasted_slot_steps)
from repro_torch.serve.counterfactual import (CounterfactualService,
                                              ServiceAnswer, Ticket)

__all__ = ["ServeEngine", "RequestBatch", "ServePlan", "estimate_exit_steps",
           "plan_compactions", "wasted_slot_steps",
           "CounterfactualService", "ServiceAnswer", "Ticket"]
