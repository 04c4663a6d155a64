from repro_torch.kernels.block_hash import kernel, ops, ref  # noqa: F401
