from .fmindex import DeviceIndex
