# ported from paddle_tpu/layers/__init__.py
"""``fluid.layers``: the layer functions ported so far (io, tensor, nn,
attention, sequence, rnn, control flow, the tensor arrays and beam
search, detection, the learning-rate schedulers and the generated
wrappers). Layer functions whose ops are not
registered in the port still build; running them raises the registry's
``NotImplementedError`` naming the op."""

from . import (attention, beam_search as beam_search_mod, control_flow,  # noqa: F401
               detection, io, learning_rate_scheduler, nn, rnn, sequence, tensor)
from .detection import (  # noqa: F401
    anchor_generator,
    bipartite_match,
    box_clip,
    box_coder,
    density_prior_box,
    detection_output,
    generate_proposals,
    iou_similarity,
    mine_hard_examples,
    multi_box_head,
    multiclass_nms,
    polygon_box_transform,
    prior_box,
    detection_map,
    generate_mask_labels,
    generate_proposal_labels,
    roi_align,
    roi_perspective_transform,
    roi_pool,
    rpn_target_assign,
    ssd_loss,
    target_assign,
    yolov3_loss,
)
from .beam_search import (  # noqa: F401
    array_length,
    array_read,
    array_to_tensor,
    array_write,
    beam_search,
    beam_search_decode,
    create_array,
)
from .attention import multi_head_attention, scaled_dot_product_attention  # noqa: F401
from .rnn import dynamic_gru, dynamic_lstm, dynamic_lstmp, gru_unit, lstm, lstm_unit  # noqa: F401
from .control_flow import (  # noqa: F401
    DynamicRNN,
    IfElse,
    StaticRNN,
    Switch,
    While,
    cond,
    equal,
    greater_equal,
    greater_than,
    less_equal,
    less_than,
    logical_and,
    logical_not,
    logical_or,
    not_equal,
)
from .learning_rate_scheduler import (  # noqa: F401
    append_LARS,
    cosine_decay,
    exponential_decay,
    inverse_time_decay,
    linear_lr_warmup,
    natural_exp_decay,
    noam_decay,
    piecewise_decay,
    polynomial_decay,
)
from .sequence import *  # noqa: F401,F403
from .io import (batch, create_py_reader_by_data, data, double_buffer,  # noqa: F401
                 load, py_reader, read_file, shuffle)
from .control_flow import is_empty  # noqa: F401
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
