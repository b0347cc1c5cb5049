from .fmindex import BwaIndex, DeviceIndex  # noqa: F401
