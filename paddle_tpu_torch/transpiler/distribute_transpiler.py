# ported from paddle_tpu/transpiler/distribute_transpiler.py
"""DistributeTranspiler compatibility shim.

Reference: ``python/paddle/fluid/transpiler/distribute_transpiler.py:161``
(2078 lines rewriting programs into trainer/pserver pairs with send/recv
ops, sliced param blocks and barriers) plus its NCCL2 mode (``:226``).

The port runs on one card and rewrites no program for distribution: there
is no parameter server, and meshes and sharded state wait for ROADMAP
Queue 1 item 7. This class keeps the reference's launch-script surface
working, as the JAX package's does:

- NCCL2 mode → no-op transpile; ``get_trainer_program`` returns the
  program unchanged.
- pserver mode → ``transpile`` succeeds (the trainer side is unchanged);
  ``get_pserver_program`` raises, naming what the port has instead.
"""

from __future__ import annotations

from typing import Optional

from ..core.framework import Program, default_main_program, default_startup_program

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]


class DistributeTranspilerConfig:
    """reference: distribute_transpiler.py:130 — accepted for compatibility."""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    enable_dc_asgd = False
    sync_mode = True
    runtime_split_send_recv = False
    mode = "pserver"


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._program: Optional[Program] = None
        self._startup: Optional[Program] = None
        self._trainer_id = 0
        self._trainers = 1
        self._sync_mode = True
        self._mode = "pserver"

    def transpile(
        self,
        trainer_id: int,
        program: Optional[Program] = None,
        pservers: str = "",
        trainers=1,
        sync_mode: bool = True,
        startup_program: Optional[Program] = None,
        current_endpoint: str = "",
    ):
        """reference: distribute_transpiler.py:280. ``trainers`` may be an
        int (pserver mode) or an endpoint list string (NCCL2 mode)."""
        self._program = program or default_main_program()
        self._startup = startup_program or default_startup_program()
        self._trainer_id = trainer_id
        self._sync_mode = sync_mode
        if isinstance(trainers, str) or self.config.mode == "nccl2":
            self._mode = "collective"
            eps = trainers.split(",") if isinstance(trainers, str) else []
            self._trainers = len(eps) or int(trainers or 1)
        else:
            self._mode = "pserver"
            self._trainers = int(trainers)
        # no program rewriting: the port trains on one card
        return self._program

    def get_trainer_program(self, wait_port: bool = True) -> Program:
        """reference: :554 — the trainer program is the original program."""
        if self._program is None:
            raise RuntimeError("call transpile() first")
        return self._program

    def get_pserver_program(self, endpoint: str) -> Program:
        """reference: :674 — intentionally unsupported."""
        raise NotImplementedError(
            "There is no parameter-server process in paddle_tpu_torch: a "
            "program trains on one card through Executor or CompiledProgram "
            "(captured into a CUDA graph), and sparse tables update their "
            "rows in place there (is_sparse embeddings). Launch the script "
            "as a trainer; meshes and sharded state are ROADMAP Queue 1 "
            "item 7.")

    def get_pserver_programs(self, endpoint: str):
        return self.get_pserver_program(endpoint)

    def get_startup_program(self, endpoint: str = "", pserver_program=None,
                            startup_program=None) -> Program:
        """reference: :927 — the shared startup program."""
        if self._startup is None:
            raise RuntimeError("call transpile() first")
        return self._startup
