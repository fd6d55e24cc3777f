"""Search over several plans on one GPU (counterpart of
``cruise_control_tpu.parallel``): best-of-N branches, the population search
and the shape-bucket helpers. The reference's device meshes and GSPMD
sharding are not ported: the port runs on one card."""

from .batching import pad_model_to, pow2_bucket, round_up
from .branches import (audit_violation_count, checked_violations,
                       make_branched_search, select_best,
                       select_best_audited)
from .population import (make_population_search, n_survivors,
                         population_layout, select_plan)

__all__ = ["audit_violation_count", "checked_violations",
           "make_branched_search", "make_population_search", "n_survivors",
           "pad_model_to", "population_layout", "pow2_bucket", "round_up",
           "select_best", "select_best_audited", "select_plan"]
