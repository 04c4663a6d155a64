from repro_torch.kernels.paged_attention import kernel, ops, ref  # noqa: F401
