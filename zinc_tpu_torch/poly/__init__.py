"""Polynomial layer: dense/sparse MLEs (host oracle + device engine).

The port's copy of ``zinc_tpu/poly/__init__.py``, with the same exports.
Mirrors the reference's poly/poly_f/poly_z split (zinc/src/poly*):
``mle`` holds the dense F/ℤ MLEs, ``sparse_mle`` the dict-backed sparse
twins, ``virtual`` the HyperPlonk-derived helper kit, ``util`` the index
helpers, and ``device`` the torch device engine, which, as in the JAX
package, this ``__init__`` does not import.
"""

from .mle import (
    DenseMleF,
    DenseMleZ,
    build_eq_x_r,
    build_eq_x_r_vec,
    build_eq_x_r_vec_z,
    build_eq_x_r_z,
    eq_eval,
)
from .sparse_mle import SparseMleF, SparseMleZ
from .util import bit_decompose, gen_eval_point, get_batched_nv, get_index, project
from .virtual import (
    evaluate_opt,
    fix_last_variables,
    fix_variables,
    identity_permutation,
    identity_permutation_mles,
    merge_polynomials,
    random_mle_list,
    random_permutation,
    random_permutation_mles,
    random_zero_mle_list,
)
from .virtual_z import (
    evaluate_opt_z,
    fix_last_variables_z,
    fix_variables_z,
    identity_permutation_mles_z,
    identity_permutation_z,
    merge_polynomials_z,
    random_mle_list_z,
    random_permutation_mles_z,
    random_permutation_z,
    random_zero_mle_list_z,
)

__all__ = [
    "DenseMleF",
    "DenseMleZ",
    "SparseMleF",
    "SparseMleZ",
    "build_eq_x_r",
    "build_eq_x_r_vec",
    "build_eq_x_r_vec_z",
    "build_eq_x_r_z",
    "eq_eval",
    "bit_decompose",
    "gen_eval_point",
    "get_batched_nv",
    "get_index",
    "project",
    "evaluate_opt",
    "fix_last_variables",
    "fix_variables",
    "identity_permutation",
    "identity_permutation_mles",
    "merge_polynomials",
    "random_mle_list",
    "random_permutation",
    "random_permutation_mles",
    "random_zero_mle_list",
    "evaluate_opt_z",
    "fix_last_variables_z",
    "fix_variables_z",
    "identity_permutation_z",
    "identity_permutation_mles_z",
    "merge_polynomials_z",
    "random_mle_list_z",
    "random_permutation_z",
    "random_permutation_mles_z",
    "random_zero_mle_list_z",
]
