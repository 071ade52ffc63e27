"""Model zoo of the port."""

from audiogan_tpu_torch.models.factory import (build_discriminator,
                                               build_generator)

__all__ = ["build_discriminator", "build_generator"]
