"""Model-side distribution: the logical-axis sharding rules the models read
(``sharding``). Gradient compression waits for the training slice."""
from .sharding import (DEFAULT_RULES, PARAM_AXES_RULES, axes_for_path, current_mesh,
                       logical_constraint, param_paths, params_pspecs, sharding_context,
                       spec_for)

__all__ = ["DEFAULT_RULES", "PARAM_AXES_RULES", "axes_for_path", "current_mesh",
           "logical_constraint", "param_paths", "params_pspecs", "sharding_context",
           "spec_for"]
