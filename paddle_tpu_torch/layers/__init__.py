# ported from paddle_tpu/layers/__init__.py
"""``fluid.layers``: the layer functions ported so far (io, tensor, nn,
attention, ``equal`` of control flow and the generated wrappers). The
rest of control flow, sequence, rnn,
detection, beam search and the learning-rate schedulers are not ported
yet. Layer functions whose ops are not registered in the port still
build; running them raises the registry's ``NotImplementedError`` naming
the op."""

from . import attention, control_flow, io, nn, tensor  # noqa: F401
from .attention import multi_head_attention, scaled_dot_product_attention  # noqa: F401
from .control_flow import equal  # noqa: F401
from .io import data, load  # noqa: F401
from .layer_helper import LayerHelper, ParamAttr  # noqa: F401
from .nn import *  # noqa: F401,F403
from .layer_function_generator import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .tensor import (  # noqa: F401
    assign,
    cast,
    concat,
    create_global_var,
    fill_constant,
    ones,
    reshape,
    scale,
    transpose,
    zeros,
)
