"""Test-only harnesses: deterministic fault injection for campaign
resilience tests (:mod:`repro.testing.faults`).

Nothing in here is imported by production code paths unless explicitly
armed (the ``REPRO_FAULTS`` env var / ``faults=`` kwarg), so shipping
this package costs the hot path nothing.
"""
from .faults import (ENV_VAR, FAULT_KINDS, Fault, FaultPlan,
                     InjectedPermanentError, InjectedTransientError,
                     load_plan)

__all__ = ["ENV_VAR", "FAULT_KINDS", "Fault", "FaultPlan",
           "InjectedPermanentError", "InjectedTransientError", "load_plan"]
