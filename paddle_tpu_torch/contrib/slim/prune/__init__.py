# ported from paddle_tpu/contrib/slim/prune/__init__.py
from .pruner import MagnitudePruner, Pruner, RatioPruner  # noqa: F401
from .prune_strategy import PruneStrategy, SensitivePruneStrategy  # noqa: F401
