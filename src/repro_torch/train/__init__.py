from repro_torch.train.step import make_lm_loss, make_resnet_loss  # noqa: F401
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: F401
