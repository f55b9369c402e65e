"""Models of the port: the serving workload's decoder LM, the
Transformer / BERT / causal-LM program functions and BERT's named
configs, the DeepFM CTR program function, the vision program functions
(ResNet, VGG-16, SE-ResNeXt, the MNIST MLP and LeNet-5), the book's
word2vec N-gram model, and the book's sequence models: the MovieLens
recommender, the stacked-LSTM sentiment net, the SRL tagger and the
GRU-attention translation net."""

from . import (bert, decoder_lm, deepfm, machine_translation,  # noqa: F401
               mnist, recommender, resnet, se_resnext, semantic_roles,
               stacked_lstm, transformer, vgg, word2vec)
