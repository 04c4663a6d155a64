"""Architecture configs.  Importing this package registers every
architecture the port runs so far (the other families wait for their
slices)."""
from repro_torch.configs import gemma2_27b, granite_3_8b  # noqa: F401

ALL_ARCHS = ("gemma2-27b", "granite-3-8b")
