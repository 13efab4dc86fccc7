"""Failure injection, straggler tracking and elastic remeshing (port of
``repro.fault``)."""
from repro_torch.fault.elastic import ElasticPlan, build_mesh, plan_remesh
from repro_torch.fault.failures import (FailureInjector, StepWatchdog,
                                        StragglerPolicy, WorkerFailure)

__all__ = ["FailureInjector", "StepWatchdog", "StragglerPolicy",
           "WorkerFailure", "ElasticPlan", "plan_remesh", "build_mesh"]
