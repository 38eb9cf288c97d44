from rso_torch.metrics.ate import ate_rmse

__all__ = ["ate_rmse"]
