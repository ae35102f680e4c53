"""Data-pipeline utilities (port of :mod:`apex_tpu.transformer._data`,
the reference's ``apex/transformer/_data``)."""

from apex_tpu_torch.transformer._data._batchsampler import (  # noqa: F401
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)
