"""Newbob learning-rate schedule + early stopping.

Mirrors the epoch-level LR control that the reference keeps in shell
(reference: asr_egs/wsj/steps/train_ctc_parallel.sh:28-33 defaults,
:165-190 logic): once the cross-validation token-accuracy improvement drops
below `start_halving_inc` (after `halving_after_epoch` epochs), the LR is
halved every epoch; training stops when the improvement drops below
`end_halving_inc` while halving is active (unless `min_iters` not yet
reached).  State is serializable for resume, replacing the reference's
`.epoch/.cvacc/.halving/.lrate` dotfiles (train_ctc_parallel.sh:185-189).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NewbobConfig:
    learn_rate: float = 4e-5       # recipes: 0.00004 (wsj run_ctc_phn.sh)
    max_iters: int = 25
    min_iters: Optional[int] = None
    start_halving_inc: float = 0.5  # accuracy points
    end_halving_inc: float = 0.1
    halving_factor: float = 0.5
    halving_after_epoch: int = 1


@dataclasses.dataclass
class NewbobScheduler:
    cfg: NewbobConfig
    epoch: int = 1                  # 1-based, matches reference logs
    cvacc_prev: float = 0.0
    halving: bool = False
    learn_rate: float = 0.0
    finished: bool = False          # persisted stop decision (resume guard)

    def __post_init__(self) -> None:
        if self.learn_rate == 0.0:
            self.learn_rate = self.cfg.learn_rate

    def report(self, cvacc: float) -> Tuple[bool, float]:
        """Feed this epoch's CV accuracy (percent).

        Returns (stop, next_learn_rate); advances internal state to the
        next epoch.
        """
        rel_impr = cvacc - self.cvacc_prev
        stop = False
        if self.halving and rel_impr < self.cfg.end_halving_inc:
            if self.cfg.min_iters is None or self.epoch >= self.cfg.min_iters:
                stop = True
        if not stop:
            if (
                rel_impr < self.cfg.start_halving_inc
                and self.epoch > self.cfg.halving_after_epoch
            ):
                self.halving = True
            if self.halving:
                self.learn_rate *= self.cfg.halving_factor
        self.cvacc_prev = cvacc
        self.epoch += 1
        if self.epoch > self.cfg.max_iters:
            stop = True
        # persist the stop decision: a resumed run must not re-enter
        # training after the schedule has completed (the reference's
        # `.epoch` dotfile ends the shell loop the same way —
        # steps/train_ctc_parallel.sh:132-190)
        self.finished = stop
        return stop, self.learn_rate

    # ---- resume support ----
    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "cvacc_prev": self.cvacc_prev,
            "halving": self.halving,
            "learn_rate": self.learn_rate,
            "finished": self.finished,
        }

    def load_state_dict(self, d: dict) -> None:
        self.epoch = int(d["epoch"])
        self.cvacc_prev = float(d["cvacc_prev"])
        self.halving = bool(d["halving"])
        self.learn_rate = float(d["learn_rate"])
        # older sched.json files lack the flag; epoch > max_iters is the
        # equivalent completion signal for those
        self.finished = bool(d.get("finished", self.epoch > self.cfg.max_iters))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.state_dict(), f)

    @classmethod
    def load(cls, path: str, cfg: NewbobConfig) -> "NewbobScheduler":
        with open(path) as f:
            d = json.load(f)
        sched = cls(cfg)
        sched.load_state_dict(d)
        return sched
