"""Scene converters (counterpart of ``voge_tpu.converter``); only the cuboid
generator is ported so far."""
from voge_tpu_torch.converter import cuboid as Cuboid
from voge_tpu_torch.converter.cuboid import cuboid_gauss

__all__ = ["Cuboid", "cuboid_gauss"]
