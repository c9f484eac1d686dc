from repro_torch.optim.optimizers import RMSProp, SGDM, Adam, by_name  # noqa: F401
