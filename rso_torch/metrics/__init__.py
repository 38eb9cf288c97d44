from rso_torch.metrics.ate import ate_rmse, rpe

__all__ = ["ate_rmse", "rpe"]
