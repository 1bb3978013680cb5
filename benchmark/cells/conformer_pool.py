"""A Conformer-CTC training cell: `Trainer.run_epoch` over the pool's
batches, as cells/train_pool.py drives the BiLSTM cells, with a
Conformer (eesen_tpu_torch/models/conformer.py) and AdamW.

Set-up makes the traffic (traffic/conformer_pool.py) and the weights
(`make_params`: drawn here from the configuration's widths, as
train_pool draws the BiLSTM's, so that a fault of the port's own
initialisation reaches neither side of the check) from the seed,
builds ONE Trainer, hands it the weights, drives it through
its first three steps in one `run_epoch` call, and warms up one step at
each batch length.  The window feeds the same Trainer batch after batch
in a new seeded order each pass until `seconds` have passed; it also
sums each batch's operations (metrics/conformer_costs.step_flops) into
`model_flops`, which `conformer_mfu.train` reads.

The check follows the first three steps with the plain reference
(reference/conformer_ctc.py, f32, each layer recomputed in its backward
pass) and compares the loss of each step, the first gradient (AdamW's
first moment after step 1 over (1 - b1)) and the parameters' change
after step 3 (train_pool.numbers).  The half batch leaves out the
second half of every batch's rows (no row of length 0: the batches have
none), the mean taken over the rest.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List, Optional

import torch

from benchmark import common
from benchmark.cells import train_pool
from benchmark.metrics import conformer_costs
from benchmark.reference import conformer_ctc as ref
from benchmark.traffic import conformer_pool as traffic
from eesen_tpu_torch.models.conformer import ConformerConfig


def model_config(cfg: Dict) -> ConformerConfig:
    return ConformerConfig(
        input_dim=cfg["input_dim"], d_model=cfg["d_model"],
        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        ff_expansion_factor=cfg["ff_expansion_factor"],
        conv_kernel_size=cfg["conv_kernel_size"],
        subsampling_conv_channels=cfg["subsampling_conv_channels"],
        xscaling=cfg["xscaling"], pos_emb_max_len=cfg["pos_emb_max_len"],
        num_targets=cfg["num_targets"], bn_momentum=cfg["bn_momentum"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]))


def param_shapes(cfg: Dict) -> Dict:
    """The trained tree (reference/conformer_ctc.py's layout) from the
    configuration's widths: each leaf (shape, how it starts): a float is
    the bound of a uniform draw (1/sqrt(fan-in) for a weight and its
    bias, the fan-in being the product of all but the weight's first
    axis; 1/sqrt(d_k) for u and v), "one" or "zero" a constant."""
    d, h, k = cfg["d_model"], cfg["n_heads"], cfg["conv_kernel_size"]
    c, ff = cfg["subsampling_conv_channels"], cfg["ff_expansion_factor"] * d
    f = ((cfg["input_dim"] + 1) // 2 + 1) // 2

    def weight(n_out, *n_in, bias=True):
        bound = 1.0 / math.sqrt(math.prod(n_in))
        out = {"w": ((n_out, *n_in), bound)}
        if bias:
            out["b"] = ((n_out,), bound)
        return out

    def norm():
        return {"gamma": ((d,), "one"), "beta": ((d,), "zero")}

    def ffn():
        return {"norm": norm(), "in": weight(ff, d), "out": weight(d, ff)}

    def layer():
        u = 1.0 / math.sqrt(d // h)
        return {
            "ff1": ffn(),
            "att": {"norm": norm(), "q": weight(d, d), "k": weight(d, d),
                    "v": weight(d, d), "out": weight(d, d),
                    "pos": weight(d, d, bias=False),
                    "pos_u": ((h, d // h), u), "pos_v": ((h, d // h), u)},
            "conv": {"norm": norm(), "pw1": weight(2 * d, d),
                     "dw": weight(d, k), "bn": norm(), "pw2": weight(d, d)},
            "ff2": ffn(),
            "norm_out": norm(),
        }

    return {
        "subsample": {"conv1": weight(c, 1, 3, 3), "conv2": weight(c, c, 3, 3),
                      "out": weight(d, c * f)},
        "layers": [layer() for _ in range(cfg["n_layers"])],
        "out": weight(cfg["num_targets"], d),
    }


def _walk(node) -> List:
    """The (shape, start) leaves, dict keys sorted, lists in order."""
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _walk(node[k])]
    if isinstance(node, list):
        return [x for v in node for x in _walk(v)]
    return [node]


def make_params(cfg: Dict, seed: int, device):
    """The weights from the seed: every drawn leaf cut, in sorted-key
    order, from one uniform draw on the device; BatchNorm's running
    statistics at 0 and 1 and its count at 0 under `buffers`."""
    shapes = param_shapes(cfg)
    drawn = [leaf for leaf in _walk(shapes) if isinstance(leaf[1], float)]
    sizes = [math.prod(shape) for shape, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    parts = iter(torch.split(flat, sizes))

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        shape, start = node
        if isinstance(start, float):
            return next(parts).reshape(shape) * start
        return torch.full(shape, 1.0 if start == "one" else 0.0,
                          device=device)

    params = build(shapes)
    d = cfg["d_model"]
    params["buffers"] = [
        {"mean": torch.zeros(d, device=device),
         "var": torch.ones(d, device=device),
         "count": torch.zeros((), dtype=torch.int64, device=device)}
        for _ in range(cfg["n_layers"])]
    return params


def _check_adam(cfg: Dict) -> None:
    """The port's AdamW keeps NeMo's betas and epsilon as constants: a
    configuration that states others is refused, so that an edit to it
    cannot read as a fault of the program."""
    from eesen_tpu_torch.training import optim

    o = cfg["optimizer"]
    port = {"b1": optim.ADAM_B1, "b2": optim.ADAM_B2, "eps": optim.ADAM_EPS}
    if {k: o[k] for k in port} != port:
        raise ValueError(f"the port's AdamW runs with {port}, the "
                         f"configuration states {o}")


def _norms(tree) -> List[float]:
    """train_pool's leaf norms over the trained leaves (no buffers)."""
    return train_pool._leaf_norms(
        {k: v for k, v in tree.items() if k != "buffers"})


def half_rows(batch: Dict) -> Dict:
    """The batch's first half of its rows."""
    n = max(batch["feats"].shape[0] // 2, 1)
    return {k: v[:n] for k, v in batch.items() if k != "keys"}


def readings(params0, batches, cfg, prec: str = "f32") -> Dict:
    ref.no_tf32()
    losses, g1, p3 = ref.follow(params0, batches, cfg, prec, checkpoint=True)
    delta = ref.tree_map(lambda a, b: a - b, p3, params0)
    return {"losses": losses, "g1": _norms(g1), "delta": _norms(delta)}


class Cell(train_pool.Cell):
    """Set-up, window and check of one Conformer training run."""

    def __init__(self, c: Dict, seed: int, device, tracer=None,
                 fault: Optional[str] = None, warm: bool = True):
        from eesen_tpu_torch.training.optim import OptimizerConfig
        from eesen_tpu_torch.training.trainer import (
            Trainer, TrainerConfig, TrainState, trained,
        )

        self.c, self.seed, self.device = c, seed, device
        self.cfg, self.spec = c["config"], c["traffic"]
        self.tracer = tracer or common.Tracer(False)
        o = self.cfg["optimizer"]
        _check_adam(self.cfg)
        self.lr = o["learn_rate"]
        with common.stage("traffic"):
            utts = traffic.make(self.spec, self.cfg, seed, device)
            self.batches = traffic.batches(self.spec, utts)
            del utts
        self.flops = [conformer_costs.step_flops(self.cfg, b["feat_lengths"])
                      for b in self.batches]
        self.order = traffic.pass_orders(len(self.batches), seed,
                                         self.spec["strata"])
        with common.stage("trainer"):
            params = make_params(self.cfg, seed, device)
            self.params0 = ref.tree_map(torch.clone, params)
            self.trainer = Trainer(TrainerConfig(
                model=model_config(self.cfg),
                optimizer=OptimizerConfig(
                    algorithm=o["algorithm"], max_grad=o["max_grad"],
                    weight_decay=o["weight_decay"]),
                ter_step=self.cfg["ter_step"], seed=seed), device=device)
            self.trainer.state = TrainState(
                params, self.trainer.tx.init(trained(params)), 0)
        if fault is not None:
            self._plant(fault)
        with common.stage("first_steps"):
            self.check_idx = [next(self.order)
                              for _ in range(train_pool.CHECK_STEPS)]
            self.prog = self.first_steps()
        if not warm:
            return
        with common.stage("warm_up"):
            self.warm_up()
            self.tracer.warm()
            if str(device).startswith("cuda"):
                torch.cuda.synchronize()

    def first_steps(self) -> Dict:
        """The first steps in ONE `run_epoch` call, as train_pool's: each
        step's loss per (subsampled) frame, AdamW's first moment after
        step 1 (taken when run_epoch asks for batch 2) over (1 - b1), and
        the parameters' change after the last step."""
        from eesen_tpu_torch.training.optim import unravel
        from eesen_tpu_torch.training.trainer import trained

        tr = self.trainer
        step = tr.train_step
        metrics, mu = [], []

        def recorded(*args, **kw):
            state, m = step(*args, **kw)
            metrics.append(m)
            return state, m

        def feed():
            for k, i in enumerate(self.check_idx):
                if k == 1:
                    mu.append(tr.state.opt_state.inner["mu"])
                yield train_pool._rows(self.batches[i])

        tr.train_step = recorded
        try:
            tr.run_epoch(feed(), True, self.lr)
        finally:
            tr.train_step = step
        p3 = tr.state.params
        b1 = self.cfg["optimizer"]["b1"]
        return {
            "losses": [float(m["obj_sum"]) / max(int(m["frames"]), 1)
                       for m in metrics],
            "g1": _norms(unravel(trained(p3), mu[0] / (1 - b1))),
            "delta": _norms(ref.tree_map(lambda a, b: a - b, p3,
                                         self.params0)),
        }

    def _plant(self, fault: str) -> None:
        step = self.trainer.train_step

        def frozen(state, batch, rng, lr, with_argmax=None):
            _, metrics = step(state, batch, rng, lr, with_argmax)
            return state, metrics

        def half(state, batch, rng, lr, with_argmax=None):
            return step(state, half_rows(batch), rng, lr, with_argmax)

        self.trainer.train_step = {"frozen": frozen, "half_batch": half}[
            fault]

    def window(self, seconds: float) -> Dict:
        """train_pool's window, with each drawn batch's operations summed
        into `model_flops`."""
        drawn, order = [], self.order

        def recording():
            for i in order:
                drawn.append(i)
                yield i

        self.order = recording()
        try:
            stats = super().window(seconds)
        finally:
            self.order = order
        stats["model_flops"] = sum(self.flops[i] for i in drawn)
        return stats

    def check_modes(self, modes) -> Dict[str, Dict]:
        """Free the program's state, then follow the first steps with the
        reference and compare, for each mode, the program ("program"),
        the reference with fp8 products in the program's place
        ("control") or on half of each batch's rows ("half_batch")."""
        batches = [train_pool._tensor_batch(self.batches[i], self.device)
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
            out[mode] = train_pool.numbers(
                got["losses"], got["g1"], got["delta"],
                want["losses"], want["g1"], want["delta"])
        return out
