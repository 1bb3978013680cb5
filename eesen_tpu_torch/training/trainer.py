"""The training loop: train/eval steps + epoch driver (counterpart of
eesen_tpu/training/trainer.py).

The reference's C++ binary did one epoch of SGD (src/netbin/
train-ctc-parallel.cc:144-218) and its shell did the learning-rate
schedule, early stop and resume (steps/train_ctc_parallel.sh:132-190):

- `make_train_step` returns a plain function (PyTorch runs eagerly; there
  is no jit): forward (BiLSTM stack), CTC (or CE) loss, backward through
  the LSTM and CTC kernels, clip, update.
- The greedy token-accuracy monitor (src/net/ctc-loss.cc:235 ErrorRateMSeq)
  is a device argmax + host edit distance, as in the reference.
- `make_shard_map_train_step` is the step of the mesh path (parallel/):
  each rank runs the same kernels on its rows, and one all-reduce a step
  sums the gradients over `data` (the JAX package's `psum` in
  `shard_map`; the reference averaged models through files,
  src/net/communicator.h).  On a mesh with a `model` axis each rank holds
  its blocks of the parameters; the step gathers them over its model
  group, runs at full width (the JAX package leaves `model` to XLA, which
  gathers the weights around a pallas_call), and keeps its blocks of the
  update.
- `run_epoch` and the steps mark their boundaries with the spans
  `train.*` of utils/profile.py (the input copy, the step, the host's
  wait for the step before, the token-error monitor; forward, loss,
  backward and optimizer inside a step); the epoch log line gives the
  input copy, metrics wait and monitor shares of the wall time.
- `Trainer.fit` runs the newbob epoch loop, with checkpoints written by
  `torch.save` (the JAX package uses orbax) and the same `sched.json`;
  under a mesh only rank 0 writes them, always with the whole
  parameters.

Everything runs on `device`, "cuda" unless the caller asks for "cpu", or
on the mesh's device.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from eesen_tpu_torch.models.bilstm import split_generator
from eesen_tpu_torch.models.conformer import BUFFERS, refuse
from eesen_tpu_torch.models.model import (
    AcousticModelConfig, apply_model, as_tensor, check_device, init_model,
    output_lengths,
)
from eesen_tpu_torch.ops.ce import ce_loss
from eesen_tpu_torch.ops.ctc import ctc_loss
from eesen_tpu_torch.parallel.distributed import all_gather, barrier, psum_
from eesen_tpu_torch.parallel.mesh import Mesh
from eesen_tpu_torch.parallel.sharding import (
    gather_params, local_shards, shard_batch, shard_state,
)
from eesen_tpu_torch.training.metrics import EpochReport, token_error_counts
from eesen_tpu_torch.training.optim import (
    OptimizerConfig, Optimizer, OptState, apply_updates, make_optimizer,
    tree_leaves, tree_unflatten, unravel,
)
from eesen_tpu_torch.training.schedule import NewbobConfig, NewbobScheduler
from eesen_tpu_torch.utils.logging import get_logger
from eesen_tpu_torch.utils.profile import profiler
from eesen_tpu_torch.utils.timer import Timer

log = get_logger("training.trainer")


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int


def create_train_state(
    gen: torch.Generator, model_cfg: AcousticModelConfig,
    opt_cfg: OptimizerConfig, device="cuda",
):
    """(TrainState, optimizer): parameters drawn from `gen` (a CPU
    torch.Generator) on `device`, a fresh optimizer state, step 0."""
    params = init_model(gen, model_cfg, device)
    tx = make_optimizer(opt_cfg)
    return TrainState(params, tx.init(trained(params)), 0), tx


def trained(params):
    """`params` without a Conformer's BatchNorm buffers (`buffers`): the
    tree that gradients and the optimizer see."""
    if isinstance(params, dict) and BUFFERS in params:
        return {k: v for k, v in params.items() if k != BUFFERS}
    return params


def _obj_and_metrics(params, batch, model_cfg, rng, train, loss="ctc",
                     with_argmax=True, buffers_out=None):
    """Unnormalized objective sum + monitor metrics for one batch.

    loss="ctc": per-utterance CTC negative log-likelihood over the
    model's output frames (`output_lengths`: a Conformer's subsampled
    lengths, the LSTM's input lengths).  loss="ce":
    per-frame cross entropy against frame-aligned labels (labels [B, T],
    BatchConfig(frame_labels=True)); metrics gain a `correct` count.
    A model with buffers puts their training update in `buffers_out`."""
    with profiler.track("train.forward"):
        logits = apply_model(
            params, batch["feats"], batch["feat_lengths"], model_cfg,
            train=train, rng=rng, buffers_out=buffers_out,
        )
    metrics = {}
    if with_argmax:
        metrics["argmax"] = logits.detach().argmax(dim=-1).to(torch.int32)
    if loss == "ce":
        t = logits.shape[1]
        with profiler.track("train.loss"):
            _, m = ce_loss(logits, batch["feat_lengths"],
                           batch["labels"][:, :t])
        metrics.update(
            obj_sum=m["obj_sum"], frames=m["frames"], correct=m["correct"],
        )
        return m["obj_sum"], metrics
    lengths = output_lengths(model_cfg, batch["feat_lengths"])
    with profiler.track("train.loss"):
        nll = ctc_loss(logits, lengths, batch["labels"],
                       batch["label_lengths"])
    metrics.update(obj_sum=nll.sum(), frames=lengths.sum())
    return nll.sum(), metrics


def _loss_and_metrics(params, batch, model_cfg, rng, train, loss="ctc",
                      with_argmax=True, buffers_out=None):
    obj, metrics = _obj_and_metrics(params, batch, model_cfg, rng, train,
                                    loss, with_argmax, buffers_out)
    frames = torch.clamp(metrics["frames"], min=1).to(obj.dtype)
    return obj / frames, metrics


def make_train_step(
    model_cfg: AcousticModelConfig,
    tx: Optimizer,
    loss: str = "ctc",
    with_argmax: bool = False,
) -> Callable:
    """Returns train_step(state, batch, rng, learn_rate, with_argmax=None)
    -> (state, metrics).  `batch` holds tensors on the parameters' device:
    feats [B, T, D] f32, feat_lengths [B], labels [B, L], label_lengths [B].
    `rng` (a CPU torch.Generator, or None without dropout) draws the
    step's dropout masks.  A call's
    `with_argmax` overrides the default given here (eager PyTorch needs no
    second step function for it).  The returned state holds new tensors;
    the old state is left as it was.  A Conformer's BatchNorm buffers
    (`params["buffers"]`) come back updated once a step; no gradient or
    optimizer sees them."""
    loss_kind = loss
    argmax_default = with_argmax

    def train_step(state: TrainState, batch, rng, learn_rate,
                   with_argmax: Optional[bool] = None):
        if with_argmax is None:
            with_argmax = argmax_default
        kept = trained(state.params)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(kept)]
        params = tree_unflatten(kept, leaves)
        buffers = {}
        if kept is not state.params:
            params[BUFFERS] = state.params[BUFFERS]
        loss_val, metrics = _loss_and_metrics(
            params, batch, model_cfg, rng, True, loss_kind, with_argmax,
            buffers,
        )
        with profiler.track("train.backward"):
            grads = torch.autograd.grad(loss_val, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss_val.detach()
        with profiler.track("train.optimizer"):
            new = _update(tx, state, tree_unflatten(kept, list(grads)),
                          learn_rate)
        if buffers:
            new = new._replace(params={**new.params,
                                       BUFFERS: buffers[BUFFERS]})
        return new, metrics

    return train_step


def _update(tx: Optimizer, state: TrainState, grads, learn_rate) -> TrainState:
    """Clip and update with the epoch's learning rate (newbob decides it
    between epochs): the state after one step."""
    opt_state = state.opt_state._replace(hyperparams=dict(
        state.opt_state.hyperparams, learning_rate=float(learn_rate)
    ))
    params = trained(state.params)
    updates, new_opt_state = tx.update(grads, opt_state, params)
    return TrainState(apply_updates(params, updates), new_opt_state,
                      state.step + 1)


def _global_counts(metrics, mesh: Mesh) -> None:
    """frames (and CE's `correct`) summed over `data`, one all-reduce."""
    keys = [k for k in ("frames", "correct") if k in metrics]
    counts = psum_(torch.stack([metrics[k].to(torch.int64) for k in keys]),
                   mesh)
    metrics.update(zip(keys, counts.unbind()))


def make_shard_map_train_step(
    model_cfg: AcousticModelConfig,
    tx: Optimizer,
    mesh: Mesh,
    loss: str = "ctc",
    with_argmax: bool = False,
) -> Callable:
    """The mesh's train step (the JAX package's shard_map step,
    `local_step`): train_step(state, batch, rng, learn_rate,
    with_argmax=None) -> (state, metrics) on each rank, with `batch` this
    rank's rows (`parallel.shard_batch`) and `state` placed by
    `parallel.shard_state`.

    - On a mesh with a `model` axis the parameters are first gathered over
      the rank's model group (`parallel.gather_params`, one flat bucket),
      and the step runs on the whole tree; the returned parameters are the
      rank's blocks again (`parallel.local_shards`).  The ranks of a data
      group compute the same bits.
    - The objective is normalized by the GLOBAL frame count (frames, and
      CE's `correct`, are all-reduced over `data` before the division).
    - The gradients are summed over `data` in one all-reduce of one flat
      bucket in `ravel`'s leaf order, which also carries the loss and the
      objective sum; the optimizer then clips and updates the summed
      gradient on the whole flat vector (replicated, as in JAX), so every
      rank applies the same update.
    - `argmax` is gathered over `data`, so the metrics are those of the
      whole batch on every rank.
    - `rng` is the same generator on every rank, as the JAX step's key is
      replicated: rank r's rows get rank 0's dropout masks for its local
      shape, so a step with dropout is not the single-process step over
      all the rows.
    - A Conformer is refused (NotImplementedError)."""
    refuse(model_cfg, "make_shard_map_train_step")
    loss_kind = loss
    argmax_default = with_argmax

    def train_step(state: TrainState, batch, rng, learn_rate,
                   with_argmax: Optional[bool] = None):
        if with_argmax is None:
            with_argmax = argmax_default
        state = state._replace(params=gather_params(state.params, mesh))
        leaves = [p.detach().requires_grad_() for p in
                  tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        obj, metrics = _obj_and_metrics(
            params, batch, model_cfg, rng, True, loss_kind, with_argmax
        )
        _global_counts(metrics, mesh)
        frames = torch.clamp(metrics["frames"], min=1).to(obj.dtype)
        loss_val = obj / frames
        with profiler.track("train.backward"):
            grads = torch.autograd.grad(loss_val, leaves)
        bucket = torch.cat([g.reshape(-1) for g in grads] + [
            loss_val.detach().reshape(1).to(grads[0].dtype),
            obj.detach().reshape(1).to(grads[0].dtype)])
        psum_(bucket, mesh)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=bucket[-2], obj_sum=bucket[-1])
        if "argmax" in metrics:
            metrics["argmax"] = all_gather(metrics["argmax"], mesh)
        with profiler.track("train.optimizer"):
            new = _update(tx, state, unravel(state.params, bucket[:-2]),
                          learn_rate)
        return new._replace(params=local_shards(new.params, mesh)), metrics

    return train_step


def make_eval_step(
    model_cfg: AcousticModelConfig, loss: str = "ctc",
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Cross-validation step (no backprop): the reference's
    --cross-validate=true mode (train-ctc-parallel.cc:116-119,206).  Under
    a mesh `params` are the rank's blocks, as the Trainer holds them
    (gathered over `model` first), and the metrics are summed (argmax
    gathered) over `data`."""

    def eval_step(params, batch):
        if mesh is not None:
            params = gather_params(params, mesh)
        with torch.no_grad():
            _, metrics = _loss_and_metrics(
                params, batch, model_cfg, None, False, loss
            )
        if mesh is not None:
            _global_counts(metrics, mesh)
            psum_(metrics["obj_sum"], mesh)
            metrics["argmax"] = all_gather(metrics["argmax"], mesh)
        return metrics

    return eval_step


@dataclasses.dataclass
class TrainerConfig:
    model: AcousticModelConfig = AcousticModelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    newbob: NewbobConfig = NewbobConfig()
    seed: int = 777
    report_step: int = 100       # log every N batches (reference report_step)
    checkpoint_dir: Optional[str] = None
    # the host-side token-error-rate monitor every N train batches; 1 =
    # every batch like the reference's ErrorRateMSeq (ctc-loss.cc:235).
    # CV epochs use every batch since newbob halves on CV accuracy.
    ter_step: int = 1
    # objective: "ctc" (train-ctc-parallel) or "ce" (train-ce-parallel,
    # frame-aligned labels; pair with BatchConfig(frame_labels=True))
    loss: str = "ctc"


class Trainer:
    """Epoch-level driver: newbob LR schedule, CV early stop, checkpointing.
    Parameters are drawn from torch.Generator().manual_seed(cfg.seed); each
    train step gets its own generator for dropout, split from `self.rng`
    (seeded from cfg.seed too), as the JAX trainer splits its key.

    With a `mesh` (parallel.make_mesh) the trainer runs on the mesh's
    device (not `device`): the state is rank 0's, placed by shard_state
    (on a `model` axis `state.params` holds the rank's blocks), each step
    is make_shard_map_train_step on this rank's rows of every global
    batch, and the epoch reports, so the newbob decisions, are the same
    on every rank.  `full_params()` gives the whole parameters.  Only
    rank 0 writes checkpoints, which hold the whole tensors."""

    def __init__(self, cfg: TrainerConfig, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else check_device(
            device)
        self.state, self.tx = create_train_state(
            torch.Generator().manual_seed(cfg.seed), cfg.model,
            cfg.optimizer, self.device,
        )
        if mesh is not None:
            self.state = shard_state(self.state, mesh)
            self.train_step = make_shard_map_train_step(
                cfg.model, self.tx, mesh, loss=cfg.loss)
        else:
            self.train_step = make_train_step(cfg.model, self.tx,
                                              loss=cfg.loss)
        self.eval_step = make_eval_step(cfg.model, loss=cfg.loss, mesh=mesh)
        self.sched = NewbobScheduler(cfg.newbob)
        self.rng = split_generator(torch.Generator().manual_seed(cfg.seed))

    def full_params(self):
        """The whole parameter tree, the accessor for every reader of the
        trained model (decode, model files): on a mesh with a `model` axis
        it is gathered over the rank's model group, so every rank of the
        mesh calls it; otherwise it is `state.params` itself."""
        if self.mesh is None:
            return self.state.params
        return gather_params(self.state.params, self.mesh)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {
            "feats": as_tensor(batch["feats"], torch.float32).to(self.device),
            **{k: as_tensor(batch[k], torch.int64).to(self.device)
               for k in ("feat_lengths", "labels", "label_lengths")},
        }

    def run_epoch(
        self, batches: Iterable[Dict[str, np.ndarray]], train: bool,
        learn_rate: float,
    ) -> EpochReport:
        report = EpochReport()
        timer = Timer()
        span = profiler.track
        n = 0
        ter_step = max(self.cfg.ter_step, 1) if train else 1
        # metrics are processed ONE STEP LATE: the host fetch + edit
        # distance for step t runs while step t+1 executes on the device
        pending = None   # (metrics, batch_meta, want_ter)

        def process(entry):
            metrics, meta, want_ter = entry
            feat_lengths, labels, label_lengths = meta
            with span("train.metrics_wait"):
                obj_sum = float(metrics["obj_sum"])
                frames = int(metrics["frames"])
            if want_ter and "correct" in metrics:
                # CE: frame accuracy (src/net/ce-loss.cc monitor)
                refs = frames
                errs = refs - int(metrics["correct"])
            elif want_ter:
                with span("train.monitor"):
                    errs, refs = token_error_counts(
                        metrics["argmax"].cpu().numpy(),
                        feat_lengths, labels, label_lengths,
                    )
            else:
                errs = refs = 0
            report.update(obj_sum, frames, errs, refs,
                          int(np.sum(feat_lengths > 0)))

        # the epoch log's shares of the wall time since its last line
        logged = ("train.input_copy", "train.metrics_wait", "train.monitor")
        since = (time.perf_counter_ns(), [profiler.ns[k] for k in logged])

        for batch in batches:
            batch.pop("keys", None)
            with span("train.input_copy"):
                dev_batch = self._to_device(
                    batch if self.mesh is None
                    else shard_batch(batch, self.mesh))
            with span("train.step"):
                if train:
                    # the argmax only on TER batches; CE needs none at all
                    want_ter_now = (n + 1) % ter_step == 0
                    self.state, metrics = self.train_step(
                        self.state, dev_batch, split_generator(self.rng),
                        learn_rate,
                        with_argmax=want_ter_now and self.cfg.loss != "ce",
                    )
                else:
                    metrics = self.eval_step(self.state.params, dev_batch)
            n += 1
            if pending is not None:
                process(pending)
            pending = (
                metrics,
                (output_lengths(self.cfg.model,
                                np.asarray(batch["feat_lengths"])),
                 np.asarray(batch["labels"]),
                 np.asarray(batch["label_lengths"])),
                n % ter_step == 0,
            )
            if n % self.cfg.report_step == 0:
                fps = report.total_frames / max(timer.elapsed(), 1e-9)
                now = time.perf_counter_ns()
                wall = max(now - since[0], 1)
                shares = [100.0 * (profiler.ns[k] - ns) / wall
                          for k, ns in zip(logged, since[1])]
                since = (now, [profiler.ns[k] for k in logged])
                log.info(
                    "%s batch %d: %s (%.0f frames/sec; input copy %.1f%%, "
                    "metrics wait %.1f%%, monitor %.1f%% of the wall time)",
                    "TRAIN" if train else "CV", n, report.report(), fps,
                    *shares,
                )
        if pending is not None:
            process(pending)
        return report

    def fit(
        self,
        train_batches_fn: Callable[[], Iterable[Dict[str, np.ndarray]]],
        cv_batches_fn: Callable[[], Iterable[Dict[str, np.ndarray]]],
        resume: bool = True,
    ) -> Dict[int, Dict[str, float]]:
        """Run newbob epochs until convergence; returns per-epoch metrics.

        With a checkpoint_dir and resume=True, training continues from the
        latest saved epoch (the reference resumed via its .epoch/.cvacc/
        .halving/.lrate dotfiles, steps/train_ctc_parallel.sh:74-78)."""
        if resume and self.cfg.checkpoint_dir:
            latest = self.latest_checkpoint()
            if latest is not None:
                log.info("resuming from epoch %d checkpoint", latest)
                self.restore_checkpoint(latest)
        # batch sources may take the (1-based) epoch number: the hook the
        # multi-tag augmentation rotation uses
        takes_epoch = bool(inspect.signature(train_batches_fn).parameters)
        history = {}
        while True:
            if self.sched.finished or self.sched.epoch > self.sched.cfg.max_iters:
                # a restored schedule that already signalled completion
                # trains no phantom extra epoch (steps/train_ctc_parallel.sh:
                # 132-190 ends on the final `.epoch` dotfile)
                log.info(
                    "schedule complete (epoch %d > max_iters %d or finished) "
                    "-- skipping training",
                    self.sched.epoch, self.sched.cfg.max_iters,
                )
                break
            epoch = self.sched.epoch
            lr = self.sched.learn_rate
            tr = self.run_epoch(
                train_batches_fn(epoch) if takes_epoch
                else train_batches_fn(),
                True, lr,
            )
            cv = self.run_epoch(cv_batches_fn(), False, lr)
            log.info(
                "EPOCH %d: lrate %.6g, TRAIN ACCURACY %.4f%%, "
                "VALID ACCURACY %.4f%%",
                epoch, lr, tr.token_accuracy, cv.token_accuracy,
            )
            history[epoch] = {
                "train_acc": tr.token_accuracy,
                "cv_acc": cv.token_accuracy,
                "train_obj": tr.obj_per_frame,
                "cv_obj": cv.obj_per_frame,
            }
            stop, _ = self.sched.report(cv.token_accuracy)
            if self.cfg.checkpoint_dir:
                # saved after the schedule update, so a resume continues
                # with the NEXT epoch
                self.save_checkpoint(epoch)
            if stop:
                break
        return history

    # ---- checkpointing (replaces nnet.iterN files + dotfiles) ----
    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(os.path.abspath(self.cfg.checkpoint_dir),
                            f"epoch_{epoch}", "state.pt")

    def latest_checkpoint(self) -> Optional[int]:
        d = self.cfg.checkpoint_dir
        if not d or not os.path.isdir(d):
            return None
        epochs = [
            int(name.split("_", 1)[1])
            for name in os.listdir(d)
            if name.startswith("epoch_") and name.split("_", 1)[1].isdigit()
            and os.path.exists(self._ckpt_path(int(name.split("_", 1)[1])))
        ]
        return max(epochs) if epochs else None

    def save_checkpoint(self, epoch: int) -> None:
        """epoch_<N>/state.pt (parameters, a Conformer's BatchNorm buffers
        among them, optimizer state, step) and
        sched.json, each written under a private name and renamed into
        place.  Under a mesh every rank takes part in gathering the whole
        parameters, rank 0 writes them and every rank waits for it, so
        that any rank can restore them next: the files do not depend on
        the mesh's shape."""
        st = self.state._replace(params=self.full_params())
        if self.mesh is None or self.mesh.rank == 0:
            self._write_checkpoint(epoch, st)
        if self.mesh is not None:
            barrier(self.mesh)

    def _write_checkpoint(self, epoch: int, st: TrainState) -> None:
        path = self._ckpt_path(epoch)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({
            "params": st.params,
            "opt_state": {"hyperparams": dict(st.opt_state.hyperparams),
                          "inner": dict(st.opt_state.inner)},
            "step": int(st.step),
        }, tmp)
        os.replace(tmp, path)
        sched = os.path.join(os.path.abspath(self.cfg.checkpoint_dir),
                             "sched.json")
        self.sched.save(f"{sched}.tmp")
        os.replace(f"{sched}.tmp", sched)

    def restore_checkpoint(self, epoch: int) -> None:
        """The state of epoch_<N>/state.pt (whole tensors; under a mesh
        each rank keeps its blocks) and sched.json."""
        d = torch.load(self._ckpt_path(epoch), map_location=self.device,
                       weights_only=True)
        params = d["params"]
        if self.mesh is not None:
            params = local_shards(params, self.mesh)
        self.state = TrainState(
            params,
            OptState(d["opt_state"]["hyperparams"], d["opt_state"]["inner"]),
            int(d["step"]),
        )
        sched_path = os.path.join(
            os.path.abspath(self.cfg.checkpoint_dir), "sched.json"
        )
        if os.path.exists(sched_path):
            self.sched = NewbobScheduler.load(sched_path, self.cfg.newbob)
