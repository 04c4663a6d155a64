"""Architecture configs.  Importing this package registers every
architecture the port serves so far (the other families wait for their
slices)."""
from repro_torch.configs import granite_3_8b  # noqa: F401

ALL_ARCHS = ("granite-3-8b",)
