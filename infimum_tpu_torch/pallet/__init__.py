# Copied from infimum_tpu/pallet/__init__.py; the port keeps its own host layers.
"""Chain-free pallet equivalent (extrinsics, events, errors, verifier)."""

from .chain import InfimumPallet, PalletError, Error, Event, RuntimeConfig

__all__ = ["InfimumPallet", "PalletError", "Error", "Event", "RuntimeConfig"]
