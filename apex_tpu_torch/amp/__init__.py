"""Mixed-precision policies, loss scaling and fp8 (port of
:mod:`apex_tpu.amp`).

The O0-O3 opt levels as :class:`Policy` objects applied to trees of
tensors, dynamic, static and no-op loss scalers whose state stays on the
device, fp32 master weights, the functional ``initialize`` with its
state dict, and fp8 training with delayed scaling
(:mod:`apex_tpu_torch.amp.fp8`: e4m3/e5m2 GEMMs on the card's fp8 tensor
cores through ``torch._scaled_mm``).  Plain torch ops: the JAX package's
amp layer is plain XLA.
"""

from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpConfig,
    AmpState,
    initialize,
    load_state_dict,
    state_dict,
)
from apex_tpu_torch.amp.fp8 import (  # noqa: F401
    E4M3,
    E5M2,
    Fp8Dense,
    Fp8Meta,
    fp8_quantize,
    update_meta,
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
