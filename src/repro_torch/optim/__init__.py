from repro_torch.optim.optimizers import Optimizer, adamw

__all__ = ["Optimizer", "adamw"]
