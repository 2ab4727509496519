# ported from vidsum_tpu/train/pretraining.py
"""Self-supervised pretraining: the reference's ``src/pretrain.py`` protocol.

Protocol (reference: ``src/pretrain.py:14-87``): eagerly loaded
(frame features, video rep) pairs, shuffled batches with the last partial one
dropped, :class:`~vidsum_tpu_torch.models.pretrain.PretrainModel` with the
three-loss objective (weights from the config; the reference hardcodes
``main + 0.5 center + 1 repel``, pretrain.py:63), Adam over the encoder's
parameters only, the cosine warm-up schedule with the 13,000-sample
numerator, and an encoder checkpoint every epoch.

Per-epoch streams, as in the JAX package, so that a resumed run replays an
uninterrupted one bit for bit: the shuffle is
``np.random.default_rng((seed, epoch))``, the JAX package's own stream, so
both packages visit batches in the same order; the dropout draws come from
a ``torch.Generator`` seeded with the first 64-bit word of
``np.random.SeedSequence((seed, epoch))`` (JAX's PRNG cannot be reproduced
here, so only the derivation, not the bits, matches;
``train.finetune.epoch_streams``). The model starts
from a ``torch.Generator`` seeded with ``PretrainConfig.seed``; the JAX
package's initial weights differ.

The step's losses stay on the device; they are fetched at each
``log_every`` boundary and once at the end of the epoch, never once a
step. Checkpoints (``train/checkpoint.py``): the copy to the host runs on
the caller thread after the epoch's losses are fetched, the encoding and
the write on the checkpointer's thread.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional

import torch

from vidsum_tpu_torch.config import Config
from vidsum_tpu_torch.data.collate import make_batches, pad_batch_pretrain
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.models.convert import pretrain_params_from_jax
from vidsum_tpu_torch.models.pretrain import PretrainModel
from vidsum_tpu_torch.models.simnet import count_params
from vidsum_tpu_torch.parallel.distributed import (
    is_coordinator, process_count,
)
from vidsum_tpu_torch.parallel.train_parallel import (
    make_sharded_pretrain_step,
)
from vidsum_tpu_torch.train.checkpoint import (
    AsyncCheckpointer, host_snapshot, restore_train_state,
)
from vidsum_tpu_torch.train.finetune import epoch_streams
from vidsum_tpu_torch.train.schedule import reference_pretrain_schedule
from vidsum_tpu_torch.train.steps import make_optimizer, make_pretrain_step
from vidsum_tpu_torch.utils.meters import AverageMeter

logger = logging.getLogger(__name__)

STATE_FILE = "pretrain_state.ckpt"


def pretrain(cfg: Config, dataset, workdir: str = ".", log_every: int = 4,
             mesh=None, resume: bool = False,
             batch_order: Optional[Callable[[int], List[List[int]]]] = None,
             *, device=None) -> dict:
    """Pretrain over ``dataset`` (any indexable of ``(frame_features,
    video_rep)`` pairs). Returns ``{"params": the model's state_dict,
    "history": the mean total loss of each epoch}``.

    Every ``save_every`` epochs and at the last one it writes
    ``workdir/cfg.train.pretrain_ckpt`` (the encoder's ``state_dict``, the
    scorer checkpoint ``finetune(use_pretrained=True)`` and ``cli.train
    --use_model`` read; meta ``{"epoch"}``) and ``workdir/
    pretrain_state.ckpt`` (``{"params", "opt_state"}``; meta ``{"epoch",
    "history"}``).

    - ``resume``: restart from ``pretrain_state.ckpt`` written by either
      package (a JAX file's optax state through
      ``train.checkpoint.adam_state_from_jax``).
    - ``batch_order(epoch) -> [[i, ...], ...]``: the exact batches of each
      epoch in place of the shuffle (the caller drops the last partial one).
    - ``mesh``: a ``parallel.mesh.DeviceMesh`` with ``("data", "model")``
      axes: every step is the dp x tp step
      (``parallel.train_parallel.make_sharded_pretrain_step``, dense
      route, as ``pretrain_apply``'s default is in the JAX package);
      ``batch_size`` must split over ``data`` (over every process's, in a
      multi-process run). The model lives on the mesh's first entry.
    - ``device``: ``None`` is the CUDA card (with a mesh: its first entry);
      ``"cpu"`` runs the plain path.

    In a multi-process run only the coordinator writes files.
    """
    pcfg = cfg.pretrain
    steps_per_epoch = max(pcfg.scheduler_samples // pcfg.batch_size, 1)
    schedule = reference_pretrain_schedule(pcfg.lr, steps_per_epoch,
                                           pcfg.warmup_epochs, pcfg.epochs)
    if mesh is not None:
        data = mesh.shape["data"] * process_count()
        if pcfg.batch_size % data:
            raise ValueError(f"batch_size {pcfg.batch_size} not divisible "
                             f"by the data axis ({data})")
        if device is not None and mesh.devices[0] != resolve_device(device):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"entry {mesh.devices[0]}")
        device = mesh.devices[0]
    dev = resolve_device(device)
    coord = is_coordinator()
    if workdir and coord:
        os.makedirs(workdir, exist_ok=True)
    step_fn = (make_pretrain_step(cfg.model, pcfg, schedule, device=dev)
               if mesh is None else
               make_sharded_pretrain_step(cfg.model, pcfg, schedule, mesh))
    model = PretrainModel(cfg.model, pcfg, device=dev,
                          generator=torch.Generator().manual_seed(pcfg.seed))
    trained = ([("encoder." + n, p)
                for n, p in model.encoder.named_parameters()]
               if pcfg.freeze_video_transform else model)
    optimizer = make_optimizer(trained, schedule(0), pcfg.weight_decay)
    logger.info("number of videos: %d", len(dataset))
    logger.info("number of model parameters: %d", count_params(model))

    ckpt_path = os.path.join(workdir, cfg.train.pretrain_ckpt)
    state_path = os.path.join(workdir, STATE_FILE)
    ckpt = AsyncCheckpointer()
    history: List[float] = []
    start_epoch = 0
    if resume and os.path.exists(state_path + ".meta.json"):
        meta = restore_train_state(state_path, model, optimizer,
                                   pretrain_params_from_jax)
        history = list(meta["history"])
        start_epoch = meta["epoch"] + 1
        logger.info("resuming pretraining from epoch %d", start_epoch)
    for epoch in range(start_epoch, pcfg.epochs):
        rng_np, gen = epoch_streams(pcfg.seed, epoch)
        batches = (batch_order(epoch) if batch_order is not None else
                   make_batches(len(dataset), pcfg.batch_size, shuffle=True,
                                rng=rng_np, drop_last=True))
        step_losses = []
        for i, batch_idx in enumerate(batches):
            feats, reps = zip(*[dataset[j] for j in batch_idx])
            x, v, mask = pad_batch_pretrain(
                feats, reps, pad_value=cfg.data.pad_value,
                bucket=cfg.data.length_bucket)
            step_losses.append(step_fn(model, optimizer, x, v, mask, gen))
            if (i + 1) % log_every == 0:
                total, main, center, repel = step_losses[-1].tolist()
                logger.info("Epoch %3d step %d: loss %.5f (main %.5f "
                            "center %.5f repel %.5f)", epoch, i + 1, total,
                            main, center, repel)
        if step_losses:
            epoch_loss = AverageMeter()
            for total in torch.stack(step_losses)[:, 0].cpu().tolist():
                epoch_loss.update(total, 1)
            history.append(epoch_loss.avg())
            logger.info("Total Loss %f", epoch_loss.avg())
        if coord and ((epoch + 1) % max(pcfg.save_every, 1) == 0
                      or epoch == pcfg.epochs - 1):
            params = host_snapshot(model.state_dict())
            encoder = {k[len("encoder."):]: v for k, v in params.items()
                       if k.startswith("encoder.")}
            ckpt.save(ckpt_path, encoder, meta={"epoch": epoch})
            # history is copied: the writer serialises the meta on its
            # thread while the next epoch appends to it
            ckpt.save(state_path,
                      {"params": params,
                       "opt_state": host_snapshot(optimizer.state_dict())},
                      meta={"epoch": epoch, "history": list(history)})
    ckpt.flush()
    return {"params": model.state_dict(), "history": history}
