from tt_sketch_torch.rng.hash_rng import hash_int_np  # noqa: F401
