"""Model-side distribution: the logical-axis sharding rules the models read
(``sharding``), their DTensor placements on a ``DeviceMesh``, and the int8
compressed all-reduce with error feedback over a ``PartMesh``
(``compression``)."""
from .compression import CompressedAllReduce, int8_psum_mean
from .sharding import (DEFAULT_RULES, PARAM_AXES_RULES, axes_for_path, current_mesh,
                       logical_constraint, named_sharding, param_paths, params_pspecs,
                       params_shardings, placements_for, sharding_context, spec_for)

__all__ = ["CompressedAllReduce", "DEFAULT_RULES", "PARAM_AXES_RULES", "axes_for_path",
           "current_mesh", "int8_psum_mean", "logical_constraint", "named_sharding",
           "param_paths", "params_pspecs", "params_shardings", "placements_for",
           "sharding_context", "spec_for"]
