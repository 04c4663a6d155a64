"""Architecture configs.  Importing this package registers every
architecture the port runs so far (the other families wait for their
slices)."""
from repro_torch.configs import (falcon_mamba_7b, gemma2_27b,  # noqa: F401
                                 granite_3_8b, mixtral_8x7b)

ALL_ARCHS = ("falcon-mamba-7b", "gemma2-27b", "granite-3-8b",
             "mixtral-8x7b")
