"""repro_torch.dist — execution plans (a copy of ``repro.dist.plan``) and the
planner's mesh bridge (:mod:`repro_torch.dist.bridge`)."""
from repro_torch.dist.plan import NAMED_PLANS, Gene, Plan

__all__ = ["Plan", "Gene", "NAMED_PLANS"]
