# ported from paddle_tpu/contrib/slim/prune/prune_strategy.py
"""Pruning strategies (reference: contrib/slim/prune/prune_strategy.py).

PruneStrategy re-applies the pruner's masks to the live parameter values in
the scope every ``mini_batch_pruning_frequency`` batches inside the active
epoch window — iterative magnitude pruning with recovery training between
prunings. The masks are numpy on a host copy of each parameter (as the JAX
package computes them); the pruned value goes back into the scope as a
tensor on the parameter's device, which a captured step copies into its
static state before its next replay.
"""

from __future__ import annotations

import torch

from ..core.strategy import Strategy

__all__ = ["PruneStrategy", "SensitivePruneStrategy"]


class PruneStrategy(Strategy):
    def __init__(self, pruner, mini_batch_pruning_frequency=1, start_epoch=0,
                 end_epoch=10, params=None):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner
        self.mini_batch_pruning_frequency = mini_batch_pruning_frequency
        self.params = set(params) if params else None

    def _trigger(self, context):
        return (context.batch_id % self.mini_batch_pruning_frequency == 0
                and self.start_epoch <= context.epoch_id < self.end_epoch)

    def _prune_all(self, context):
        for p in context.graph.all_parameters():
            if self.params is not None and p.name not in self.params:
                continue
            val = context.scope.find_var(p.name)
            if val is None:
                continue
            t = torch.as_tensor(val)
            v = t.detach().cpu().numpy()
            mask = self.pruner.prune(v, name=p.name)
            context.scope.set_var(p.name, torch.from_numpy(
                (v * mask).astype(v.dtype)).to(t.device))

    def on_batch_end(self, context):
        if self._trigger(context):
            self._prune_all(context)


class SensitivePruneStrategy(Strategy):
    """Scaffolding parity (reference: SensitivePruneStrategy holds
    sensitivities config; the full sensitivity search was never finished in
    the reference either — the fields are carried for config parity)."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=10,
                 delta_rate=0.20, acc_loss_threshold=0.2, sensitivities=None):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner
        self.delta_rate = delta_rate
        self.acc_loss_threshold = acc_loss_threshold
        self.sensitivities = sensitivities or {}
