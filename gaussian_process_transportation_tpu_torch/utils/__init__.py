from .resample import resample

__all__ = ["resample"]
