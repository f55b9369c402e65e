# ported from paddle_tpu/contrib/slim/graph/__init__.py
from .graph import Graph, ImitationGraph  # noqa: F401
