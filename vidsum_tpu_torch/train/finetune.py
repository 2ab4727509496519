# ported from vidsum_tpu/train/finetune.py
"""Supervised finetuning: the reference's ``src/train.py`` protocol.

Protocol (reference: ``src/train.py:21-108``): per DSNet fold, a fixed seed,
a fresh model, Adam with coupled weight decay, an optional pretrained warm
start, then epochs of masked-MSE train steps and a val pass (sigmoid scores
-> KTS/knapsack summary -> F/tau/rho); per fold the **max over epochs** of
each metric, then the mean across folds. A summary JSON export runs once per
fold, with the fold's initial weights, like ``train.py:77``.

Per-(split, epoch) streams (the JAX package folds (split, epoch) into its
seed so that a resumed run replays the same bits): the shuffle is
``np.random.default_rng((seed, split, epoch))``, the JAX package's own
stream, so both packages visit batches in the same order; the dropout draws
come from a ``torch.Generator`` seeded with the first 64-bit word of
``np.random.SeedSequence((seed, split, epoch))`` (JAX's PRNG cannot be
reproduced here, so only the derivation, not the bits, matches). Every fold
starts from ``SimNet`` seeded with ``cfg.train.seed`` (the JAX package's
initial weights differ; a pretrained or saved checkpoint replaces them).

Checkpoints (``train/checkpoint.py``) are ``torch.save`` files; the
pretrained and warm-start files, and the resume state, may also be the JAX
package's msgpack files. The copy of parameters and Adam state to the host
runs on the caller thread after the val pass; encoding and writing run on
the checkpointer's thread, overlapping the next epoch.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vidsum_tpu_torch.config import Config
from vidsum_tpu_torch.data.collate import (
    bucket_length, item_weights, make_batches, pad_batch,
)
from vidsum_tpu_torch.data.datasets import TSDataset
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.export.summary_json import write_summary_json
from vidsum_tpu_torch.models.simnet import SimNet, count_params
from vidsum_tpu_torch.ops.metrics import eval_metrics
from vidsum_tpu_torch.parallel.distributed import (
    is_coordinator, process_count,
)
from vidsum_tpu_torch.parallel.dp_shardmap import (
    make_dp_shardmap_finetune_step,
)
from vidsum_tpu_torch.parallel.train_parallel import (
    make_sharded_finetune_step,
)
from vidsum_tpu_torch.train.checkpoint import (
    AsyncCheckpointer, host_snapshot, load_model_state, restore_train_state,
)
from vidsum_tpu_torch.train.steps import (
    make_eval_forward, make_finetune_step, make_optimizer,
)
from vidsum_tpu_torch.utils.meters import AverageMeter
from vidsum_tpu_torch.utils.metrics_log import MetricsLogger
from vidsum_tpu_torch.utils.profiling import trace

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FinetuneResult:
    fscore: float
    kendall_tau: float
    spearman_rho: float
    per_split: List[Dict[str, float]]


def epoch_streams(*key: int) -> Tuple[np.random.Generator, torch.Generator]:
    """The shuffle and dropout streams of one epoch, keyed ``(seed, split,
    epoch)`` here and ``(seed, epoch)`` in pretraining."""
    words = np.random.SeedSequence(key).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(words[0]) & (2 ** 63 - 1))
    return np.random.default_rng(key), gen


def _train_epoch(step_fn, model, optimizer, dataset, cfg: Config,
                 rng_np: np.random.Generator,
                 generator: torch.Generator, epoch_batches=None,
                 pad_to_batch: bool = False) -> float:
    """One epoch of ``step_fn`` (``train.steps.make_finetune_step``, or a
    mesh step of ``parallel/``) over shuffled batches; the model and
    optimizer update in place. Returns the mean step loss. The step losses
    stay on the device until the end of the epoch: one host fetch per
    epoch, not per step. ``epoch_batches`` (lists of indices) replaces the
    shuffled order, e.g. with the realised permutation of the reference's
    ``DataLoader(shuffle=True)``. ``pad_to_batch`` (a mesh, whose shards
    need equal rows) fills the last batch by repeating its own videos and
    passes their ``item_weights`` (1, or 0 at a repeat), so the padded step
    is the smaller batch's."""
    batches = (epoch_batches if epoch_batches is not None else
               make_batches(len(dataset), cfg.train.batch_size, shuffle=True,
                            rng=rng_np, pad_to_batch=pad_to_batch))
    step_losses = []
    for batch_idx in batches:
        items = [dataset[i] for i in batch_idx]
        x, t, mask = pad_batch([it[0] for it in items],
                               [it[1] for it in items],
                               pad_value=cfg.data.pad_value,
                               bucket=cfg.data.length_bucket)
        weights = ({"item_weight": item_weights(batch_idx)}
                   if pad_to_batch else {})
        step_losses.append(step_fn(model, optimizer, x, t, mask, generator,
                                   **weights))
    loss_avg = AverageMeter()
    if step_losses:
        for loss in torch.stack(step_losses).cpu().tolist():
            loss_avg.update(loss, 1)
    return loss_avg.avg()


def _val_epoch(fwd, model, dataset, cfg: Config, val_batch: int = 8):
    """Sigmoid scores per video -> ``eval_metrics`` (reference
    train.py:134-152). Videos are grouped by length bucket and scored in
    batches (a video's scores do not depend on its batch). Returns
    (val loss, F, tau, rho)."""
    groups = defaultdict(list)
    for i in range(len(dataset)):
        groups[bucket_length(dataset[i][0].shape[0],
                             cfg.data.length_bucket)].append(i)

    score_dict, user_dict = {}, {}
    loss_avg = AverageMeter()
    for bucket in sorted(groups):
        idxs = groups[bucket]
        for start in range(0, len(idxs), val_batch):
            items = [dataset[i] for i in idxs[start:start + val_batch]]
            x, _, mask = pad_batch([it[0] for it in items],
                                   [it[1] for it in items],
                                   pad_value=cfg.data.pad_value,
                                   bucket=cfg.data.length_bucket)
            preds = fwd(model, x, mask).float().cpu().numpy()
            for row, (feats, target, user) in zip(preds, items):
                pred = row[: feats.shape[0]]
                loss_avg.update(float(np.mean((pred - target) ** 2)), 1)
                score_dict[user.name] = pred
                user_dict[user.name] = user
    f, k, s = eval_metrics(score_dict, user_dict,
                           eval_method=cfg.eval.eval_method,
                           budget_ratio=cfg.eval.budget_ratio,
                           impl=cfg.eval.impl,
                           device=next(model.parameters()).device)
    return loss_avg.avg(), f, k, s


def fold_datasets(cfg: Config, split: Dict[str, List[str]]
                  ) -> Tuple[TSDataset, TSDataset]:
    """A fold's (train set, val set) over the h5 files under
    ``cfg.data.root`` (the JAX ``finetune.py:260-267``): the only place the
    fold loop builds datasets."""
    d = cfg.data
    train_set = TSDataset(d.root, d.ex_dataset, d.datasets,
                          split["train_keys"], split="train",
                          min_frames=d.min_train_frames,
                          path_scheme=d.path_scheme)
    val_set = TSDataset(d.root, d.ex_dataset, d.datasets, split["test_keys"],
                        split="val", path_scheme=d.path_scheme)
    return train_set, val_set


def mesh_step(cfg: Config, mesh, dev: torch.device):
    """The train step over ``mesh`` (the JAX ``finetune.py:202-221``, with
    the card for the TPU): the kernels' data-parallel step where ``model``
    is 1 on CUDA, else the dp x tp step. Raises the JAX ``ValueError`` where
    ``batch_size`` does not split over the run's data axis."""
    data = mesh.shape["data"] * process_count()
    if cfg.train.batch_size % data:
        raise ValueError(f"batch_size {cfg.train.batch_size} not divisible "
                         f"by the data axis ({data})")
    if mesh.shape.get("model", 1) == 1 and dev.type == "cuda":
        return make_dp_shardmap_finetune_step(cfg.model, mesh)
    return make_sharded_finetune_step(cfg.model, mesh)


def finetune(cfg: Config, splits: Sequence[Dict[str, List[str]]],
             workdir: str = ".", export_summary: bool = True,
             profile_dir: Optional[str] = None, resume: bool = False,
             metrics_path: Optional[str] = None, mesh=None,
             batch_order: Optional[Callable] = None, *,
             device=None) -> FinetuneResult:
    """Run the finetune + eval protocol over ``splits`` (folds of
    ``train_keys`` / ``test_keys``). Returns the fold-averaged max-over-epoch
    metrics (reference train.py:98-108).

    - ``profile_dir``: trace the first epoch of the first fold
      (``utils.profiling.trace``, a Chrome trace).
    - ``resume``: restart from ``workdir/train_state.ckpt`` (parameters,
      Adam state, epoch and the per-fold metric history), written by either
      package; the streams are per (split, epoch), so a resumed run gives
      the bits of a straight one.
    - ``metrics_path``: append one JSON line per epoch and a final one.
    - ``batch_order(split_idx, epoch) -> [[i, ...], ...]``: the exact train
      batch order of each epoch in place of the shuffle.
    - ``mesh``: a ``parallel.mesh.DeviceMesh`` with ``("data", "model")``
      axes (``make_mesh(MeshConfig(...))``): the step runs over it, chosen
      as the JAX package chooses (:func:`mesh_step`). Batches are padded to
      ``batch_size`` with weighted repeats. The model lives on the mesh's
      first entry.
    - ``device``: ``None`` is the CUDA card (with a mesh: its first entry);
      ``"cpu"`` runs the plain path.

    In a multi-process run (``parallel.distributed.init_distributed``) every
    process runs this loop over its part of the mesh and only the
    coordinator writes files.
    """
    if mesh is not None:
        if device is not None and mesh.devices[0] != resolve_device(device):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"entry {mesh.devices[0]}")
        device = mesh.devices[0]
    dev = resolve_device(device)
    coord = is_coordinator()
    if workdir and coord:
        os.makedirs(workdir, exist_ok=True)
    metrics = MetricsLogger(metrics_path if coord else None)
    ckpt = AsyncCheckpointer()
    state_path = os.path.join(workdir, "train_state.ckpt")
    resume_meta = None
    if resume and os.path.exists(state_path + ".meta.json"):
        with open(state_path + ".meta.json") as f:
            resume_meta = json.load(f)
        logger.info("resuming from split %d epoch %d", resume_meta["split"],
                    resume_meta["epoch"] + 1)

    avg_f, avg_k, avg_s = AverageMeter(), AverageMeter(), AverageMeter()
    per_split = list(resume_meta["per_split"]) if resume_meta else []
    for sb in per_split:
        avg_f.update(sb["fscore"], 1)
        if not np.isnan(sb["kendall_tau"]):
            avg_k.update(sb["kendall_tau"], 1)
            avg_s.update(sb["spearman_rho"], 1)

    tc = cfg.train
    step_fn = (make_finetune_step(cfg.model, tc.attn_impl, device=dev)
               if mesh is None else mesh_step(cfg, mesh, dev))
    fwd = make_eval_forward(cfg.model, device=dev)

    start_split = resume_meta["split"] if resume_meta else 0
    for split_idx, split in enumerate(splits):
        if split_idx < start_split:
            continue
        logger.info("Split %d", split_idx + 1)
        ckpt.flush()  # checkpoint files may be read back below
        model = SimNet(cfg.model, device=dev,
                       generator=torch.Generator().manual_seed(tc.seed))
        pretrain_path = os.path.join(workdir, tc.pretrain_ckpt)
        if tc.use_pretrained and os.path.exists(pretrain_path):
            model.load_state_dict(load_model_state(pretrain_path)[0])
            logger.info("loaded pretrained encoder from %s", pretrain_path)
        save_path = os.path.join(workdir, tc.save_ckpt)
        if tc.warm_start_from_save and os.path.exists(save_path):
            model.load_state_dict(load_model_state(save_path)[0])
        optimizer = make_optimizer(model, tc.lr, tc.weight_decay)
        logger.info("model has %d parameters", count_params(model))

        train_set, val_set = fold_datasets(cfg, split)
        if export_summary and coord:
            write_summary_json(fwd, model, val_set, cfg,
                               os.path.join(workdir, "summary.json"))

        fs, ks, ss = [], [], []
        start_epoch = 0
        if resume_meta and split_idx == resume_meta["split"]:
            restore_train_state(state_path, model, optimizer)
            fs = list(resume_meta["fs"])
            ks = list(resume_meta["ks"])
            ss = list(resume_meta["ss"])
            start_epoch = resume_meta["epoch"] + 1
            resume_meta = None
        for epoch in range(start_epoch, tc.max_epoch):
            t0 = time.time()
            rng_np, gen = epoch_streams(tc.seed, split_idx, epoch)
            with trace(profile_dir if split_idx == 0 and epoch == 0
                       else None):
                train_loss = _train_epoch(
                    step_fn, model, optimizer, train_set, cfg, rng_np, gen,
                    epoch_batches=(batch_order(split_idx, epoch)
                                   if batch_order is not None else None),
                    pad_to_batch=mesh is not None)
            last_epoch = epoch == tc.max_epoch - 1
            save_state = coord and (
                (epoch + 1) % max(tc.state_save_every, 1) == 0 or last_epoch)
            save_model = coord and (
                (epoch + 1) % max(tc.model_save_every, 1) == 0 or last_epoch)
            val_loss, f, k, s = _val_epoch(fwd, model, val_set, cfg)
            fs.append(f)
            if not (np.isnan(k) or np.isnan(s)):
                ks.append(k)
                ss.append(s)
            logger.info("Epoch %d: train %.4f val %.4f F %.2f tau %.4f "
                        "rho %.4f (%.1fs)", epoch, train_loss, val_loss, f,
                        k, s, time.time() - t0)
            metrics.log({"split": split_idx, "epoch": epoch,
                         "train_loss": train_loss, "val_loss": val_loss,
                         "fscore": f, "kendall_tau": k, "spearman_rho": s})
            # one copy to the host for both files, on this thread; encoding
            # and writing overlap the next epoch on the checkpointer's
            host_params = (host_snapshot(model.state_dict())
                           if save_model or save_state else None)
            if save_model:
                ckpt.save(save_path, host_params,
                          meta={"epoch": epoch, "split": split_idx})
            if save_state:
                ckpt.save(
                    state_path,
                    {"params": host_params,
                     "opt_state": host_snapshot(optimizer.state_dict())},
                    # the lists are copied: the writer serialises the meta on
                    # its thread while this loop appends to them
                    meta={"epoch": epoch, "split": split_idx,
                          "per_split": list(per_split), "fs": list(fs),
                          "ks": list(ks), "ss": list(ss)})

        split_best = {"fscore": max(fs),
                      "kendall_tau": max(ks) if ks else float("nan"),
                      "spearman_rho": max(ss) if ss else float("nan")}
        per_split.append(split_best)
        avg_f.update(split_best["fscore"], 1)
        if ks:
            avg_k.update(split_best["kendall_tau"], 1)
            avg_s.update(split_best["spearman_rho"], 1)

    ckpt.flush()
    result = FinetuneResult(avg_f.avg(),
                            avg_k.avg() if avg_k.num else float("nan"),
                            avg_s.avg() if avg_s.num else float("nan"),
                            per_split)
    logger.info("Total fscore: %.4f  tau: %.4f  rho: %.4f", result.fscore,
                result.kendall_tau, result.spearman_rho)
    metrics.log({"final_fscore": result.fscore,
                 "final_kendall_tau": result.kendall_tau,
                 "final_spearman_rho": result.spearman_rho})
    metrics.close()
    return result
