"""Mixed-precision policies and loss scaling (port of
:mod:`apex_tpu.amp`, without its fp8 names).

The O0-O3 opt levels as :class:`Policy` objects applied to trees of
tensors, dynamic, static and no-op loss scalers whose state stays on the
device, fp32 master weights, and the functional ``initialize`` with its
state dict.  Plain torch ops: the JAX package's amp layer is plain XLA.
"""

from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpConfig,
    AmpState,
    initialize,
    load_state_dict,
    state_dict,
)
from apex_tpu_torch.amp.master import (  # noqa: F401
    MasterWeights,
    make_master,
    master_to_model,
)
from apex_tpu_torch.amp.policy import (  # noqa: F401
    O0,
    O1,
    O2,
    O3,
    Policy,
    cast_floating,
    cast_to_compute,
    cast_to_output,
    cast_to_param,
    policy,
)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    DynamicLossScale,
    LossScaleState,
    NoOpLossScale,
    StaticLossScale,
    all_finite,
    scale_loss,
)
