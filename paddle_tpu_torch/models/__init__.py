"""Models of the port: the serving workload's decoder LM, the
Transformer / BERT / causal-LM program functions and BERT's named
configs, the DeepFM CTR program function, the vision program functions
(ResNet, VGG-16, SE-ResNeXt, the MNIST MLP and LeNet-5) and the book's
word2vec N-gram model."""

from . import (bert, decoder_lm, deepfm, mnist, resnet,  # noqa: F401
               se_resnext, transformer, vgg, word2vec)
