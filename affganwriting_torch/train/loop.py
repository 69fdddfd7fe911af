"""Word-GAN training loop: epochs, evaluation, early stopping, the plateau
schedule and checkpoints with full resume.

The port of ``affganwriting_tpu/train/loop.py`` (the reference's
GAN_word/main_runold.py:234-272).  Each epoch runs the R -> C -> D+G step
(``train/step.py``) over the ``(seed, epoch)`` batch stream of the training
writers; every ``eval_every`` epochs the eval step runs over the held-out
writers, and the summed validation CER drives early stopping, R's plateau
schedule and the best checkpoint.  ``latest`` holds the parameters, the
BatchNorm statistics and the optimizers' state (Adam's moments and step),
so a trainer built on the same logdir resumes where it stopped.

As in the JAX trainer, nothing inside the epoch reads a value back from the
device: the metrics and R's logits stay device tensors until the pass after
the loop, which averages the losses and computes the CERs.  Dropout masks
come from one ``torch.Generator`` on the device, seeded from ``seed``; on a
resume it is seeded afresh, as the JAX trainer re-seeds its key.

On a mesh (``mesh=``, one process per device, ``parallel/mesh.py``) every
rank builds the same global batches, keeps its slice and runs the sharded
step (``train/step.py``), whose metrics are the global batch's; the CER
counts are summed over the 'data' group, so the epoch's results and the
early-stop decision are the same on every rank.  Every rank restores;
only rank 0 writes checkpoints (all ranks gather the tensor-parallel
shards for it, ``parallel/mesh.unsharded``), metrics and sheets.  The
synthetic words seed from ``hash(word)``: ranks that should render the
same images need one ``PYTHONHASHSEED``.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Optional

import numpy as np
import torch

from affganwriting_torch.core.checkpoint import CheckpointManager
from affganwriting_torch.core.config import VOCAB, WordGanConfig
from affganwriting_torch.data.prefetch import prefetch
from affganwriting_torch.data.words import WordStyleDataset
from affganwriting_torch.eval.cer import CERAccumulator
from affganwriting_torch.gen.inference import resolve_device
from affganwriting_torch.parallel.mesh import (
    shard_batch,
    shard_state,
    unsharded,
)
from affganwriting_torch.parallel.ops import reduce_values
from affganwriting_torch.train.eval_step import make_eval_step
from affganwriting_torch.train.schedules import PlateauScaler
from affganwriting_torch.train.state import init_state, set_rec_lr
from affganwriting_torch.train.step import make_phased_train_step
from affganwriting_torch.utils.logging import MetricsLogger, NullLogger
from affganwriting_torch.utils.memwatch import maybe_restart


@dataclasses.dataclass
class EarlyStopping:
    """Stop when the monitored value has not improved for ``patience``
    evaluations (GAN_word/main_runold.py:201-231)."""

    patience: int = 20
    best: float = float("inf")
    count: int = 0
    should_stop: bool = False

    def update(self, value: float) -> None:
        if value < self.best:
            self.best = value
            self.count = 0
        else:
            self.count += 1
            if self.count >= self.patience:
                self.should_stop = True


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


class WordGanTrainer:
    mesh = None      # one device: this process writes its own files
    writer = True

    def __init__(
        self,
        config: WordGanConfig,
        train_data: WordStyleDataset,
        test_data: Optional[WordStyleDataset] = None,
        logdir: str = "runs/word_gan",
        seed: int = 0,
        eval_every: int = 20,
        save_every: int = 100,
        save_latest_every_steps: int = 250,
        patience: int = 20,
        rec_plateau: bool = False,
        restart_rss_gb: float = 48.0,
        device=None,
        mesh=None,
    ):
        """Runs on the card unless ``device="cpu"``, or on ``mesh``'s
        device.  Resumes from ``<logdir>/ckpt/latest`` when it exists."""
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.mesh = mesh
        if mesh is not None and config.batch_size % mesh.data:
            raise ValueError(
                f"batch_size {config.batch_size} not divisible by the mesh "
                f"'data' axis ({mesh.data})")
        self.writer = mesh is None or _rank() == 0
        self.config = config
        self.train_data = train_data
        self.test_data = test_data
        self.logger = MetricsLogger(logdir) if self.writer else NullLogger()
        self.logdir = logdir
        self.ckpt = CheckpointManager(f"{logdir}/ckpt", write=self.writer)
        self.eval_every = eval_every
        self.save_every = save_every
        self.save_latest_every_steps = save_latest_every_steps
        self.early = EarlyStopping(patience)
        # 0 disables the host-RSS watchdog (utils/memwatch.py)
        self.restart_rss_gb = restart_rss_gb
        self.plateau = (PlateauScaler() if rec_plateau
                        and not config.rec_frozen else None)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.state = init_state(config, self.device, seed)
        self.train_step = make_phased_train_step(
            config, merge_dg=config.merge_dg, device=self.device, mesh=mesh)
        self.eval_step = make_eval_step(config, device=self.device,
                                        mesh=mesh)
        self.start_epoch = 0
        self._gsteps = 0
        self._interrupted = False
        if mesh is not None:
            # rank 0 finishes a swap a crash left half done before any
            # rank looks for the file
            import torch.distributed as dist

            if self.writer:
                self.ckpt.latest_exists()
            dist.barrier()
        if self.ckpt.latest_exists():
            self.ckpt.restore("latest", self.state)
            self.start_epoch = self.state.step // max(
                1, len(train_data) // config.batch_size)
            print(f"resumed from latest at epoch ~{self.start_epoch}")
        if mesh is not None:
            shard_state(mesh, self.state)

    def _place(self, batch: dict) -> dict:
        """This rank's slice of a global batch on a mesh."""
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def _saved(self, save, *args) -> None:
        """``save(self.state, self.config, *args)`` with the state whole:
        on a mesh every rank gathers, rank 0 writes (the manager of every
        other rank writes nothing), and all wait for the file."""
        if self.mesh is None:
            save(self.state, self.config, *args)
            return
        import torch.distributed as dist

        with unsharded(self.state):
            save(self.state, self.config, *args)
        dist.barrier()

    def train_epoch(self, epoch: int) -> dict:
        """One pass over the training writers; logs and returns the
        epoch-mean losses, the CERs of R on the real words (``cer_tr``) and
        on both fakes (``cer_te``, ``cer_te2``), the epoch's seconds and
        steps per second."""
        n = 0
        t0 = time.time()
        pending = []
        # batches are built on a background thread (data/prefetch.py)
        for batch in prefetch(self.train_data.batches(epoch=epoch)):
            batch = self._place(batch)
            self.state, metrics, extras = self.train_step(
                self.state, batch, self.generator)
            # keep only what the CER pass reads, not the style stacks
            pending.append((metrics, {
                "cer_tr": (extras["rec_logits_tr"], batch["label_ch0"]),
                "cer_te": (extras["logits_xt"], batch["label_xt"]),
                "cer_te2": (extras["logits_swap"], batch["label_xt_swap"]),
            }))
            n += 1
            self._gsteps += 1
            self._stop_if_interrupted()
            if self._gsteps % self.save_latest_every_steps == 0:
                self._saved(self.ckpt.save_latest)
        out = self._reduce(pending, n, ("cer_tr", "cer_te", "cer_te2"))
        out["epoch_seconds"] = time.time() - t0
        out["steps_per_sec"] = n / max(out["epoch_seconds"], 1e-9)
        self.logger.log(epoch, out, group="train")
        return out

    def _reduce(self, pending, n: int, cer_keys: tuple) -> dict:
        """Epoch means of the metrics and the CER of each (logits or ids,
        labels) pair, read back from the device after the loop.  On a mesh
        the metrics are already the global batch's and the CER counts of
        this rank's rows are summed over the 'data' group."""
        sums: dict[str, float] = {}
        cers = {k: CERAccumulator() for k in cer_keys}
        for metrics, pairs in pending:
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            for k, (pred, labels) in pairs.items():
                ids = pred.argmax(-1) if pred.is_floating_point() else pred
                cers[k].add(
                    ids, torch.as_tensor(labels, device=ids.device))
        if self.mesh is not None and self.mesh.data > 1:
            counts = reduce_values(
                {f"{k}/{f}": torch.tensor(float(getattr(acc, f)),
                                          device=self.device)
                 for k, acc in cers.items() for f in ("ed", "length")},
                self.mesh.data_group)
            for k, acc in cers.items():
                acc.ed, acc.length = (int(counts[f"{k}/{f}"])
                                      for f in ("ed", "length"))
        out = {k: v / max(n, 1) for k, v in sums.items()}
        out.update({k: acc.value() for k, acc in cers.items()})
        return out

    def evaluate(self, epoch: int) -> float:
        """Runs the eval step over the held-out writers; logs the mean
        losses and ``cer_te``, ``cer_te2``, writes an image sheet of the
        first batch, and returns ``cer_te + cer_te2``, the early-stop
        monitor (main_runold.py:261-268)."""
        assert self.test_data is not None
        pending, first, n = [], None, 0
        for batch in self.test_data.batches(epoch=epoch, shuffle=False):
            batch = self._place(batch)
            metrics, preds, images = self.eval_step(self.state, batch)
            if n == 0:
                first = (batch, preds, images)
            pending.append((metrics, {
                "cer_te": (preds["pred_xt"], batch["label_xt"]),
                "cer_te2": (preds["pred_swap"], batch["label_xt_swap"])}))
            n += 1
        if first is not None and self.writer:
            self._dump_sheet(epoch, *first)
        out = self._reduce(pending, n, ("cer_te", "cer_te2"))
        self.logger.log(epoch, out, group="eval")
        return out["cer_te"] + out["cer_te2"]

    def _dump_sheet(self, epoch, batch, preds, images) -> None:
        from affganwriting_torch.eval.sheets import write_sheet

        def decode(rows):
            return [VOCAB.decode(r) for r in np.asarray(rows)]

        def host(t):
            return t.float().cpu().numpy()

        try:
            write_sheet(
                f"{self.logdir}/sheets", f"eval_{epoch}",
                host(images["xg"]), decode(preds["pred_xt"].cpu()),
                batch["img_xt"], decode(batch["label_xt"]),
                batch["style_imgs"], host(images["xg_swap"]),
                decode(preds["pred_swap"].cpu()),
                decode(batch["label_xt_swap"]))
        except Exception as e:  # a sheet must never stop training
            print(f"sheet dump failed: {e}")

    def _plateau_step(self, monitor: float) -> None:
        """ReduceLROnPlateau on R's rate (GAN_word/main_run.py:279)."""
        if self.plateau is None or self.state.rec.opt is None:
            return
        mul = self.plateau.update(monitor)
        set_rec_lr(self.state, self.config.lr_rec * mul)

    def _stop_if_interrupted(self) -> None:
        """After a SIGINT inside ``fit``: save ``latest`` and raise
        ``KeyboardInterrupt``.  Called only where no step is running."""
        if self._interrupted:
            print("SIGINT: saving latest checkpoint before exit")
            self._saved(self.ckpt.save_latest)
            raise KeyboardInterrupt

    def fit(self, epochs: int) -> None:
        """Train epochs ``start_epoch .. epochs - 1``, then save ``latest``.
        SIGINT saves ``latest`` (the last completed step) before it raises
        ``KeyboardInterrupt`` (reference line_generation/train.py:75-78).
        The step updates the players in place, one after another, so the
        handler only raises a flag: the save waits for the running step to
        finish (``train_epoch`` checks after each step, ``fit`` after the
        epoch's steps and at the end of each epoch)."""
        def _sigint(signum, frame):
            self._interrupted = True

        self._interrupted = False
        prev = signal.signal(signal.SIGINT, _sigint)
        try:
            for epoch in range(self.start_epoch, epochs):
                self.train_epoch(epoch)
                self._stop_if_interrupted()
                if (self.test_data is not None
                        and epoch % self.eval_every == 0):
                    monitor = self.evaluate(epoch)
                    self._plateau_step(monitor)
                    self._saved(self.ckpt.maybe_save_best, monitor)
                    self.early.update(monitor)
                    if self.early.should_stop:
                        print(f"early stop at epoch {epoch} "
                              f"(best {self.early.best:.3f})")
                        break
                if epoch % self.save_every == 0 and epoch > 0:
                    self._saved(self.ckpt.save_step, epoch)
                self._stop_if_interrupted()
                maybe_restart(
                    self.restart_rss_gb,
                    lambda: self._saved(self.ckpt.save_latest),
                    label="word-gan")
            self._saved(self.ckpt.save_latest)
        finally:
            signal.signal(signal.SIGINT, prev)
