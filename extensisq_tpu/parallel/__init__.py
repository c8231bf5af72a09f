from .pde import (heat_1d_rhs, heat_2d_rhs, brusselator_2d_rhs,
                  brusselator_rho_bound, make_mesh, shard_state)
from .halo import heat_1d_rhs_shardmap
from .hierarchy import make_hierarchical_mesh, ensemble_pde_sharding

__all__ = ["heat_1d_rhs", "heat_2d_rhs", "brusselator_2d_rhs",
           "brusselator_rho_bound", "make_mesh", "shard_state",
           "heat_1d_rhs_shardmap", "make_hierarchical_mesh",
           "ensemble_pde_sharding"]
