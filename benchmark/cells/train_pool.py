"""A training cell: `Trainer.run_epoch` over the pool's batches.

Set-up makes the traffic and the weights from the seed, builds ONE
Trainer, hands it the weights, and drives it through its first three
steps in one `run_epoch` call over three different batches, fed as the
window feeds it; the reference later follows the same three steps.  One more
step at each batch length of the pool warms up every shape.  The window
then feeds the same Trainer batch after batch, pass after pass in a new
seeded order, through one `run_epoch` call until `seconds` have passed;
it closes at a `torch.cuda.synchronize()` after the last step.

`train_audio_s_per_s` is the real (unpadded) audio of every step of the
window over the window's wall time.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import common
from benchmark.reference import bilstm_ctc as ref
from benchmark.reference.quant import no_tf32
from benchmark.traffic import train_pool

CHECK_STEPS = 3


def model_config(cfg: Dict):
    from eesen_tpu_torch.models.model import AcousticModelConfig

    return AcousticModelConfig(
        input_dim=cfg["input_dim"], cell_dim=cfg["cell_dim"],
        num_layers=cfg["num_layers"], num_targets=cfg["num_targets"],
        param_range=cfg["param_range"], fgate_bias=cfg["fgate_bias"],
        forward_dropout=cfg["forward_dropout"],
        recurrent_dropout=cfg["recurrent_dropout"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        state_bf16=cfg["state_bf16"], bidirectional=cfg["bidirectional"],
    )


def param_shapes(cfg: Dict):
    """The port's parameter tree as shapes."""
    h, v = cfg["cell_dim"], cfg["num_targets"]
    layers = []
    for i in range(cfg["num_layers"]):
        d = cfg["input_dim"] if i == 0 else 2 * h
        direction = {"w_gifo_x": (d, 4, h), "w_gifo_m": (h, 4, h),
                     "bias": (4, h), "phole_i_c": (h,), "phole_f_c": (h,),
                     "phole_o_c": (h,)}
        layers.append({"fw": dict(direction), "bw": dict(direction)})
    return {"layers": layers, "out": {"w": (2 * h, v), "b": (v,)}}


def make_params(cfg: Dict, seed: int, device):
    """Uniform +-param_range weights from the seed, drawn on the device
    in one call and cut into the tree (leaves in sorted-key order); the
    forget gates' bias gets fgate_bias."""
    def walk(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k])]
        if isinstance(node, list):
            return [x for v in node for x in walk(v)]
        return [node]

    shapes = param_shapes(cfg)
    sizes = [int(np.prod(s)) for s in walk(shapes)]
    gen = torch.Generator(device=device).manual_seed(seed)
    r = cfg["param_range"]
    flat = (torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1) * r
    parts = iter(torch.split(flat, sizes))

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(parts).reshape(node).clone()

    params = build(shapes)
    for lp in params["layers"]:
        for d in lp.values():
            d["bias"][2] += cfg["fgate_bias"]
    return params


def _rows(batch: Dict) -> Dict:
    """A batch for one run_epoch call (run_epoch pops its `keys`)."""
    return {k: v for k, v in batch.items() if k != "keys"}


def _tensor_batch(batch: Dict, device) -> Dict:
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in ("feats", "feat_lengths", "labels", "label_lengths")}


def _leaf_norms(tree) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double()))
            for _, t in ref.leaves(tree)]


def _gap(p_norms, r_norms, keep=None) -> float:
    """Worst leaf of |norm_p - norm_r| / max(norm_r, median norm_r)."""
    idx = [i for i in range(len(r_norms)) if keep is None or keep[i]]
    med = statistics.median(r_norms[i] for i in idx)
    return max(abs(p_norms[i] - r_norms[i]) / max(r_norms[i], med, 1e-30)
               for i in idx)


def numbers(losses_p, g1_p, delta_p, losses_r, g1_r, delta_r) -> Dict:
    """The three compared numbers of a training cell."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    gr = _gap(g1_p, g1_r)
    med_g = statistics.median(g1_r)
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone: left out of the change
    keep = [g >= 1e-3 * med_g for g in g1_r]
    common.log(f"leaves left out of delta_gap: {len(keep) - sum(keep)} "
               f"of {len(keep)}")
    return {"loss_gap": loss_gap, "grad_gap": gr,
            "delta_gap": _gap(delta_p, delta_r, keep)}


def readings(params0, batches, cfg, prec: str = "f32") -> Dict:
    """(losses, first gradient norms, change norms) of the reference at
    `prec` following the first steps from params0."""
    no_tf32()
    losses, g1, p3 = ref.follow(params0, batches, cfg["optimizer"], prec)
    delta = ref.tree_map(lambda a, b: a - b, p3, params0)
    return {"losses": losses, "g1": _leaf_norms(g1),
            "delta": _leaf_norms(delta)}


def half_rows(batch: Dict) -> Dict:
    """The batch with the second half of its utterances left out (length
    0), so that the loss is the mean over the rest."""
    out = dict(batch)
    n = int((batch["feat_lengths"] > 0).sum()) // 2
    for k in ("feat_lengths", "label_lengths"):
        out[k] = batch[k].clone()
        out[k][n:] = 0
    return out


class Cell:
    """Set-up, window and check of one training run."""

    def __init__(self, c: Dict, seed: int, device, tracer=None,
                 fault: Optional[str] = None, warm: bool = True):
        from eesen_tpu_torch.training.optim import OptimizerConfig
        from eesen_tpu_torch.training.trainer import (
            Trainer, TrainerConfig, TrainState,
        )

        self.c, self.seed, self.device = c, seed, device
        self.cfg, self.spec = c["config"], c["traffic"]
        self.tracer = tracer or common.Tracer(False)
        o = self.cfg["optimizer"]
        self.lr = o["learn_rate"]
        with common.stage("traffic"):
            utts = train_pool.make(self.spec, self.cfg, seed, device)
            self.batches = train_pool.batches(self.spec, utts)
            del utts
        self.order = train_pool.pass_orders(len(self.batches), seed,
                                            self.spec["strata"])
        with common.stage("trainer"):
            params = make_params(self.cfg, seed, device)
            self.params0 = ref.tree_map(torch.clone, params)
            self.trainer = Trainer(TrainerConfig(
                model=model_config(self.cfg),
                optimizer=OptimizerConfig(
                    algorithm=o["algorithm"], momentum=o["momentum"],
                    max_grad=o["max_grad"]),
                ter_step=self.cfg["ter_step"], seed=seed), device=device)
            self.trainer.state = TrainState(
                params, self.trainer.tx.init(params), 0)
        if fault is not None:
            self._plant(fault)
        with common.stage("first_steps"):
            self.check_idx = [next(self.order) for _ in range(CHECK_STEPS)]
            self.prog = self.first_steps()
        if not warm:
            return
        with common.stage("warm_up"):
            self.warm_up()
            self.tracer.warm()
            if str(device).startswith("cuda"):
                torch.cuda.synchronize()

    def first_steps(self) -> Dict:
        """Drive the Trainer through its first steps in ONE `run_epoch`
        call over the check's batches, fed as the window feeds it, and
        keep what the check compares: each step's loss per frame (from
        the metrics that the step returned to run_epoch), the first
        gradient as the optimizer holds it (the momentum trace after step
        1, taken when run_epoch asks for batch 2; the step replaces it,
        never writes it in place) and the parameters' change after the
        last step."""
        from eesen_tpu_torch.training.optim import unravel

        tr = self.trainer
        step = tr.train_step
        metrics, g1 = [], []

        def recorded(*args, **kw):
            state, m = step(*args, **kw)
            metrics.append(m)
            return state, m

        def feed():
            for k, i in enumerate(self.check_idx):
                if k == 1:
                    g1.append(tr.state.opt_state.inner["trace"])
                yield _rows(self.batches[i])

        tr.train_step = recorded
        try:
            tr.run_epoch(feed(), True, self.lr)
        finally:
            tr.train_step = step
        p3 = tr.state.params
        return {
            "losses": [float(m["obj_sum"]) / max(int(m["frames"]), 1)
                       for m in metrics],
            "g1": _leaf_norms(unravel(p3, g1[0])),
            "delta": _leaf_norms(ref.tree_map(lambda a, b: a - b, p3,
                                              self.params0)),
        }

    def warm_up(self) -> None:
        """One step of the Trainer's own step function at every batch
        length of the pool (the widest labels of each), so that the window
        finds every shape's allocations and plans made.  The host's
        token-error monitor of run_epoch has nothing to warm."""
        from eesen_tpu_torch.models.bilstm import split_generator

        widest = {}
        for b in self.batches:
            t, l = b["feats"].shape[1], b["labels"].shape[1]
            if t not in widest or l > widest[t]["labels"].shape[1]:
                widest[t] = b
        tr = self.trainer
        for t in sorted(widest, reverse=True):
            rows = _tensor_batch(widest[t], self.device)
            for k in ("feat_lengths", "labels", "label_lengths"):
                rows[k] = rows[k].long()
            tr.state, _ = tr.train_step(tr.state, rows,
                                        split_generator(tr.rng), self.lr,
                                        with_argmax=True)

    def _plant(self, fault: str) -> None:
        """Break the timed path underneath (the harness's own tests)."""
        step = self.trainer.train_step

        def frozen(state, batch, rng, lr, with_argmax=None):
            _, metrics = step(state, batch, rng, lr, with_argmax)
            return state, metrics

        def half(state, batch, rng, lr, with_argmax=None):
            return step(state, half_rows(batch), rng, lr, with_argmax)

        self.trainer.train_step = {"frozen": frozen, "half_batch": half}[
            fault]

    def window(self, seconds: float) -> Dict:
        spec = self.spec
        n_trace = spec["trace_steps"]
        t_first = 2                       # traced stretch: steps 2..2+n
        stats = {"steps": 0, "real_frames": 0, "padded_frames": 0,
                 "traced": []}
        tracer = self.tracer

        def feed(t0):
            i = 0
            while time.perf_counter() - t0 < seconds or (
                    tracer.enabled and i <= t_first + n_trace):
                if tracer.enabled and i == t_first:
                    tracer.start()
                if tracer.enabled and i == t_first + n_trace:
                    tracer.stop()
                b = self.batches[next(self.order)]
                if tracer.enabled and t_first <= i < t_first + n_trace:
                    tracer.mark(f"step{i}")
                    stats["traced"].append(b)
                stats["steps"] += 1
                stats["real_frames"] += int(b["feat_lengths"].sum())
                stats["padded_frames"] += int(b["feats"].shape[0]
                                              * b["feats"].shape[1])
                i += 1
                yield _rows(b)

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.trainer.run_epoch(feed(t0), True, self.lr)
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        stats["window_s"] = time.perf_counter() - t0
        stats["attempted"] = stats["steps"]
        stats["audio_s"] = stats["real_frames"] * self.cfg["frame_s"]
        return stats

    def end_to_end(self, stats: Dict) -> Dict:
        return {"train_audio_s_per_s": {
            "value": stats["audio_s"] / stats["window_s"],
            "unit": "audio-s/s"}}

    def check(self, stats: Dict = None, mode: str = "program") -> Dict:
        return self.check_modes((mode,))[mode]

    def check_modes(self, modes) -> Dict[str, Dict]:
        """Free the program's state, then follow the first steps with the
        reference and compare with them, for each mode, the program's
        readings ("program"), the reference in fp8 put in the program's
        place ("control"), or the reference with half of each batch left
        out ("half_batch")."""
        batches = [_tensor_batch(self.batches[i], self.device)
                   for i in self.check_idx]
        self.trainer = None
        self.batches = None
        gc.collect()
        if str(self.device).startswith("cuda"):
            torch.cuda.empty_cache()
        want = readings(self.params0, batches, self.cfg)
        out = {}
        for mode in modes:
            if mode == "program":
                got = self.prog
            elif mode == "control":
                got = readings(self.params0, batches, self.cfg, "fp8")
            else:
                got = readings(self.params0,
                               [half_rows(b) for b in batches], self.cfg)
            out[mode] = numbers(got["losses"], got["g1"], got["delta"],
                                want["losses"], want["g1"], want["delta"])
        return out
