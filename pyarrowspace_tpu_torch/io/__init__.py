from .convert import STATE_KEYS, state_from_numpy

__all__ = ["STATE_KEYS", "state_from_numpy"]
