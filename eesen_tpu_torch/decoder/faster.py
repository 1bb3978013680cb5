"""Host-side token-passing Viterbi decoder (reference implementation).

A direct, readable equivalent of the reference's best-path decoder
(reference: src/decoder/faster-decoder.{h,cc} — FasterDecoder:
ProcessEmitting/ProcessNonemitting with beam + max_active pruning;
src/decoder/decodable-matrix.h:47-54 — the tid-1 shift mapping graph
input label t to acoustic-matrix column t-1, blank = column 0).

Used to validate the batched TPU beam search (decoder/beam.py) and as the
fallback decoder for tiny jobs.  The hot production path is beam.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from eesen_tpu_torch.decoder.fst import EPS, Fst

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class FasterDecoderOptions:
    """reference: faster-decoder.h FasterDecoderOptions (beam 16, and
    decode_ctc.sh passes beam/acoustic_scale)."""
    beam: float = 16.0
    max_active: int = 5000
    min_active: int = 20
    acoustic_scale: float = 0.9


@dataclasses.dataclass
class _Token:
    cost: float
    prev: Optional["_Token"]
    ilabel: int
    olabel: int


class FasterDecoder:
    """Frame-synchronous Viterbi over a TLG graph for one utterance."""

    def __init__(self, fst: Fst, opts: FasterDecoderOptions = FasterDecoderOptions()):
        self.fst = fst
        self.opts = opts

    def decode(self, loglikes: np.ndarray) -> Tuple[List[int], List[int], float]:
        """loglikes: [T, V] log-posterior/pseudo-likelihood matrix (column 0
        = blank).  Returns (ilabels per frame incl. eps, olabels = words,
        total cost)."""
        opts = self.opts
        cur: Dict[int, _Token] = {
            self.fst.start: _Token(0.0, None, 0, 0)
        }
        cur = self._process_nonemitting(cur)
        for t in range(loglikes.shape[0]):
            cur = self._process_emitting(cur, loglikes[t])
            cur = self._process_nonemitting(cur)
            if not cur:
                return [], [], INF
        # final
        best: Optional[Tuple[float, _Token]] = None
        for s, tok in cur.items():
            fw = self.fst.final_weight(s)
            if fw != INF:
                c = tok.cost + fw
                if best is None or c < best[0]:
                    best = (c, tok)
        if best is None:  # no final state reached: use best token
            for s, tok in cur.items():
                if best is None or tok.cost < best[0]:
                    best = (tok.cost, tok)
        cost, tok = best
        ilabels: List[int] = []
        olabels: List[int] = []
        while tok is not None:
            if tok.ilabel != EPS:
                ilabels.append(tok.ilabel)
            if tok.olabel != EPS:
                olabels.append(tok.olabel)
            tok = tok.prev
        ilabels.reverse()
        olabels.reverse()
        return ilabels, olabels, cost

    # ---- internals ----
    def _cutoff(self, toks: Dict[int, _Token]) -> float:
        """Adaptive beam/max_active cutoff (faster-decoder.cc GetCutoff)."""
        costs = np.array([t.cost for t in toks.values()])
        best = costs.min()
        beam_cutoff = best + self.opts.beam
        if len(costs) > self.opts.max_active:
            k_cut = np.partition(costs, self.opts.max_active)[
                self.opts.max_active
            ]
            return min(beam_cutoff, k_cut)
        return beam_cutoff

    def _process_emitting(
        self, toks: Dict[int, _Token], loglike_t: np.ndarray
    ) -> Dict[int, _Token]:
        cutoff = self._cutoff(toks)
        out: Dict[int, _Token] = {}
        scale = self.opts.acoustic_scale
        for s, tok in toks.items():
            if tok.cost > cutoff:
                continue
            for a in self.fst.arcs[s]:
                if a.ilabel == EPS:
                    continue
                # tid-1 shift: graph label 1 (<blk>) -> acoustic column 0
                ac = -scale * loglike_t[a.ilabel - 1]
                c = tok.cost + a.weight + ac
                old = out.get(a.nextstate)
                if old is None or c < old.cost:
                    out[a.nextstate] = _Token(c, tok, a.ilabel, a.olabel)
        return out

    def _process_nonemitting(self, toks: Dict[int, _Token]) -> Dict[int, _Token]:
        if not toks:
            return toks
        cutoff = self._cutoff(toks)
        queue = list(toks.keys())
        while queue:
            s = queue.pop()
            tok = toks[s]
            if tok.cost > cutoff:
                continue
            for a in self.fst.arcs[s]:
                if a.ilabel != EPS:
                    continue
                c = tok.cost + a.weight
                old = toks.get(a.nextstate)
                if old is None or c < old.cost:
                    toks[a.nextstate] = _Token(c, tok, EPS, a.olabel)
                    queue.append(a.nextstate)
        return toks
