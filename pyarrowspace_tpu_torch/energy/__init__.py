from .maps import EnergyMaps, build_energy_maps

__all__ = ["EnergyMaps", "build_energy_maps"]
