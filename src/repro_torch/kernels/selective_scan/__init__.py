from repro_torch.kernels.selective_scan import kernel, ops, ref  # noqa: F401
