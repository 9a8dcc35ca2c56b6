"""Helpers: device selection, input validation, JAX weight bridge."""

from .device import resolve_device

__all__ = ["resolve_device"]
