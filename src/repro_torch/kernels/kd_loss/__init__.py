from repro_torch.kernels.kd_loss import ops, ref  # noqa: F401
