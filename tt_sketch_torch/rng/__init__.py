from tt_sketch_torch.rng.hash_rng import (  # noqa: F401
    hash_int_np,
    inds_to_normal_np,
    inds_to_sparse_sign_np,
    lazy_gaussian_matrix,
)
