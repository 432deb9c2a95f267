from .device import resolve_device  # noqa: F401
