"""Runnable recipes (counterpart of the repository's ``examples/``):
:mod:`apex_tpu_torch.examples.imagenet_amp`, ImageNet ResNet training."""
