"""Search over several plans on one GPU (counterpart of
``cruise_control_tpu.parallel``): best-of-N branches, the population search,
the shape-bucket helpers and the mesh-less sharding path
(:mod:`.sharding`: a mesh is one device, every sharding the identity)."""

from .batching import pad_model_to, pow2_bucket, round_up
from .branches import (audit_violation_count, checked_violations,
                       make_branched_search, select_best,
                       select_best_audited)
from .population import (make_population_search, n_survivors,
                         population_layout, select_plan)
from .sharding import (make_mesh, mesh_fingerprint, resolve_mesh_devices,
                       shard_model)

__all__ = ["audit_violation_count", "checked_violations",
           "make_branched_search", "make_mesh", "make_population_search",
           "mesh_fingerprint", "n_survivors", "pad_model_to",
           "population_layout", "pow2_bucket", "resolve_mesh_devices",
           "round_up", "select_best", "select_best_audited", "select_plan",
           "shard_model"]
