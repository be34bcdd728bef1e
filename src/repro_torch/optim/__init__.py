from .adamw import (AdamW, AdamWState, apply_updates, opt_state_from_jax,
                    tree_leaves, tree_map)

__all__ = ["AdamW", "AdamWState", "apply_updates", "opt_state_from_jax",
           "tree_leaves", "tree_map"]
