"""ResNet-50, the paper's own ImageNet benchmark model [He et al. 2016]
(`repro/configs/resnet50.py`).

Used for the paper-faithful convergence and scaling runs (DASO against sync
on an image classifier with node-local batch norm). The CNN family lives in
`repro_torch.models.cnn`; the LM entry points (`launch.train`,
`launch.serve`) do not take it: `train.loop.run_training` with
`train.step.make_resnet_loss` and `launch.ablation` train it.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    family: str = "cnn"
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    bottleneck: bool = True
    n_classes: int = 1000
    image_size: int = 224
    # the reference's field; both packages initialize and train in f32
    param_dtype: str = "float32"
    source: str = "[He et al., CVPR 2016; paper's own benchmark]"


CONFIG = ResNetConfig()


def reduced() -> ResNetConfig:
    """Tiny same-family variant for CPU smoke tests / convergence runs."""
    return ResNetConfig(
        name="resnet-tiny", stage_sizes=(1, 1), width=8, bottleneck=False,
        n_classes=10, image_size=32)
