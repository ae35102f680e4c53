"""Reference models of the example and benchmark workloads (counterpart of
:mod:`apex_tpu.models`): the ResNet family of the ImageNet O2 slice."""

from apex_tpu_torch.models import resnet  # noqa: F401
from apex_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet50,
    ResNet101,
)

__all__ = ["ResNet", "ResNet18", "ResNet50", "ResNet101", "resnet"]
