"""The compiled TLG: the device arc tables that the native build
(fst_native.build_full_compiled) returns and `save` writes as one .npz,
in the layout that eesen_tpu_torch's `CompiledGraph.load` reads.

Arcs are CSR tables split into emitting (ilabel > 0) and epsilon
(ilabel == 0) arcs, every state's out-degree capped at `max_degree` by a
tree of auxiliary states, with the epsilon arcs' transitive closure
precomputed (closure_offsets / closure_packed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CompiledGraph:
    """Device-ready TLG; every array is numpy."""
    num_states: int                 # incl. auxiliary states
    start: int
    # emitting arcs CSR (ilabel > 0)
    emit_offsets: np.ndarray        # [N+1] int32
    emit_ilabel: np.ndarray         # [Ee] int32 (graph token id; col = id-1)
    emit_olabel: np.ndarray         # [Ee] int32
    emit_weight: np.ndarray         # [Ee] float32
    emit_dst: np.ndarray            # [Ee] int32
    # epsilon arcs CSR (ilabel == 0)
    eps_offsets: np.ndarray         # [N+1] int32
    eps_olabel: np.ndarray          # [En] int32
    eps_weight: np.ndarray          # [En] float32
    eps_dst: np.ndarray             # [En] int32
    final_weight: np.ndarray        # [N] float32 (inf = non-final)
    max_emit_degree: int
    max_eps_degree: int
    eps_depth: int                  # max eps-chain length (closure iters)
    # hub tables: dense always-expanded emit arcs of high-fanout states
    hub_src: Optional[np.ndarray] = None        # [H] int32
    hub_offsets: Optional[np.ndarray] = None    # [H+1] int32
    hub_packed: Optional[np.ndarray] = None     # [Eh, 4] int32
    # precomputed eps transitive closure (single-phase expansion)
    closure_offsets: Optional[np.ndarray] = None  # [N+1] int32
    closure_packed: Optional[np.ndarray] = None   # [Ec, 4] int32
    max_closure_degree: int = 0

    @property
    def num_emit_arcs(self) -> int:
        return len(self.emit_ilabel)

    @property
    def num_eps_arcs(self) -> int:
        return len(self.eps_dst)

    _SCALARS = ("num_states", "start", "max_emit_degree", "max_eps_degree",
                "eps_depth", "max_closure_degree")
    _ARRAYS = ("emit_offsets", "emit_ilabel", "emit_olabel", "emit_weight",
               "emit_dst", "eps_offsets", "eps_olabel", "eps_weight",
               "eps_dst", "final_weight", "hub_src", "hub_offsets",
               "hub_packed", "closure_offsets", "closure_packed")

    def save(self, path: str) -> None:
        """Write the compiled arrays as one .npz (no pickle)."""
        d = {k: np.asarray(getattr(self, k)) for k in self._SCALARS}
        for k in self._ARRAYS:
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        np.savez(path, **d)
