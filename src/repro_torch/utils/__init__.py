from repro_torch.utils.tree import (
    tree_add,
    tree_sub,
    tree_scale,
    tree_zeros_like,
    tree_dot,
    tree_l2_norm,
    tree_size,
    tree_bytes,
    tree_weighted_mean,
    tree_cast,
    flatten_to_vector,
    unflatten_from_vector,
)

__all__ = [
    "tree_add",
    "tree_sub",
    "tree_scale",
    "tree_zeros_like",
    "tree_dot",
    "tree_l2_norm",
    "tree_size",
    "tree_bytes",
    "tree_weighted_mean",
    "tree_cast",
    "flatten_to_vector",
    "unflatten_from_vector",
]
