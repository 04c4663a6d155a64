from repro_torch.kernels.abft_matmul import kernel, ops, ref  # noqa: F401
