from .convert import STATE_KEYS, state_from_numpy
from .persist import FORMAT_VERSION, load_index, save_index

__all__ = ["STATE_KEYS", "state_from_numpy", "FORMAT_VERSION", "load_index",
           "save_index"]
