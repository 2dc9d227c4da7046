from cavmd_tpu_torch.utils.minimize import fire_minimize

__all__ = ["fire_minimize"]
