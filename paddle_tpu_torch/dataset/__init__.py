# ported from paddle_tpu/dataset/__init__.py
from . import cifar, mnist, uci_housing  # noqa: F401
from .text import conll05, imdb, imikolov, movielens, wmt16  # noqa: F401
