from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    ArchConfig,
    MoEConfig,
    get_config,
    get_reduced,
    reduce_config,
    require_lm,
)
from repro_torch.configs.resnet50 import ResNetConfig  # noqa: F401
