from repro_torch.kernels.weight_avg import ops, ref  # noqa: F401
