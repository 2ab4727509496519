# ported from vidsum_tpu/train/finetune.py (the epoch loop; the finetune()
# fold loop, which reads h5 datasets and writes checkpoints, arrives with the
# data slice)
"""One finetune epoch and one validation pass, the loop the reference's
``src/train.py:21-108`` runs per fold, over any indexable dataset whose
items start with ``(features (n, in_features), gtscore (n,))`` and, for
validation, carry a :class:`~vidsum_tpu_torch.data.datasets.UserSummaries`
third.

Per-(split, epoch) streams (the JAX package folds (split, epoch) into its
seed so that a resumed run replays the same bits): the shuffle is
``np.random.default_rng((seed, split, epoch))``, the JAX package's own
stream, so both packages visit batches in the same order; the dropout draws
come from a ``torch.Generator`` seeded with the first 64-bit word of
``np.random.SeedSequence((seed, split, epoch))`` (JAX's PRNG cannot be
reproduced here, so only the derivation, not the bits, matches).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Tuple

import numpy as np
import torch

from vidsum_tpu_torch.config import Config
from vidsum_tpu_torch.data.collate import (
    bucket_length, make_batches, pad_batch,
)
from vidsum_tpu_torch.ops.metrics import eval_metrics
from vidsum_tpu_torch.utils.meters import AverageMeter


def epoch_streams(seed: int, split: int, epoch: int
                  ) -> Tuple[np.random.Generator, torch.Generator]:
    """The shuffle and dropout streams of one (split, epoch)."""
    words = np.random.SeedSequence((seed, split, epoch)).generate_state(
        1, np.uint64)
    gen = torch.Generator().manual_seed(int(words[0]) & (2 ** 63 - 1))
    return np.random.default_rng((seed, split, epoch)), gen


def _train_epoch(step_fn, model, optimizer, dataset, cfg: Config,
                 rng_np: np.random.Generator,
                 generator: torch.Generator) -> float:
    """One epoch of ``step_fn`` (``train.steps.make_finetune_step``) over
    shuffled batches; the model and optimizer update in place. Returns the
    mean step loss. The step losses stay on the device until the end of the
    epoch: one host fetch per epoch, not per step. (The JAX loop's
    ``pad_to_batch``, for its device mesh, and ``epoch_batches``, for its
    ``finetune(batch_order=...)``, arrive with those callers.)"""
    batches = make_batches(len(dataset), cfg.train.batch_size, shuffle=True,
                           rng=rng_np)
    step_losses = []
    for batch_idx in batches:
        items = [dataset[i] for i in batch_idx]
        x, t, mask = pad_batch([it[0] for it in items],
                               [it[1] for it in items],
                               pad_value=cfg.data.pad_value,
                               bucket=cfg.data.length_bucket)
        step_losses.append(step_fn(model, optimizer, x, t, mask, generator))
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
                           impl=cfg.eval.impl)
    return loss_avg.avg(), f, k, s
