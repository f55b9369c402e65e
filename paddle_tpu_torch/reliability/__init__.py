# ported from paddle_tpu/reliability/__init__.py
"""paddle_tpu_torch.reliability — deterministic fault injection (the chaos
layer) and the retry-policy oracle the serving engine consults. The
supervisor and the sentinel are not ported yet."""

from . import faults  # noqa: F401
from .faults import (FaultPlan, FaultSpec, InjectedFault,  # noqa: F401
                     TransientFault, classify)

__all__ = ["faults", "FaultPlan", "FaultSpec", "InjectedFault",
           "TransientFault", "classify"]
