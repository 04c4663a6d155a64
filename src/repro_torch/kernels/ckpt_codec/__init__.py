from repro_torch.kernels.ckpt_codec import kernel, ops, ref  # noqa: F401
