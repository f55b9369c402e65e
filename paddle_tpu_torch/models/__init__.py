"""Models of the port: the serving workload's decoder LM, the
Transformer / BERT / causal-LM program functions and BERT's named
configs, the DeepFM CTR program function, and the vision program
functions (ResNet, the MNIST MLP and LeNet-5)."""

from . import bert, decoder_lm, deepfm, mnist, resnet, transformer  # noqa: F401
