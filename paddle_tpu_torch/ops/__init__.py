"""Op implementation library of the port — importing this package
registers every ported op: attention math, the training slice's ops, the
sequence and recurrent families, the structured losses (the CRF, CTC,
the sampled heads), control flow, the tensor arrays and beam search, the
metric, vision-tail and remaining general ops, the host ops, the
fake-quantization ops, the detection ops, and the hand-written kernels
under :mod:`.kernels`."""

from . import (  # noqa: F401
    activation_ops,
    attention_ops,
    beam_search_ops,
    compare_ops,
    control_flow_ops,
    detection_ops,
    extra_ops,
    gradient_ops,
    loss_ops,
    math_ops,
    metric_ops,
    misc_ops,
    nn_ops,
    optimizer_ops,
    quantize_ops,
    reduce_ops,
    rnn_ops,
    sequence_ops,
    tensor_ops,
    vision_ops,
)
