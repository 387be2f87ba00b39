"""Serving of the port: single-token decode and the generation loop
(``decode``), the planner-as-a-service plan cache (``plan_cache``) and
its load test (``python -m repro_torch.serve.loadtest``)."""

from .plan_cache import (PlanCache, PlanService, RefinementQueue,
                         default_plan_service, planner_enabled,
                         reset_default_plan_service)

__all__ = [
    "PlanCache", "PlanService", "RefinementQueue", "default_plan_service",
    "planner_enabled", "reset_default_plan_service",
]
