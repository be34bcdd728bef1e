"""The mesh: sharding rules and DTensor placements (``sharding``) and the
data-parallel gradient collectives (``collectives``)."""
from .collectives import broadcast_object
from .sharding import (MODEL_AXIS, batch_axes_for, batch_spec_tree,
                       cache_spec_tree, distribute, distribute_tree,
                       full_tree, make_ctx, map_tree, mesh_shape,
                       param_spec_tree, place, placements, zero_spec,
                       zero_spec_tree)

__all__ = ["MODEL_AXIS", "batch_axes_for", "batch_spec_tree",
           "broadcast_object", "cache_spec_tree", "distribute", "distribute_tree", "full_tree",
           "make_ctx", "map_tree", "mesh_shape", "param_spec_tree",
           "place", "placements", "zero_spec", "zero_spec_tree"]
