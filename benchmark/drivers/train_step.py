"""Driver of the training cells: the port's training step
(``train.steps.make_pretrain_step`` or ``make_finetune_step``) called in a
loop, as ``train.pretraining.pretrain`` and ``train.finetune`` call it, on
host batches a prefetching loader would hand over.

Set-up builds the model, the optimizer and the step once, makes a pool of
distinct padded batches from the seed (on the device, then to host memory,
as the collate functions lay them out), and drives the step through its
first three batches, which all differ; the reference follows those three.
It then steps once through the rest of the pool, so that every shape of the
window has run. The window steps on through the pool in an order drawn from
the seed until ``--seconds`` have passed, then synchronises.

Traffic keys: ``step`` (``pretrain`` or ``finetune``), ``attn_impl``,
``route`` (the dropout family the cell's lengths take: ``block`` or
``flash``), ``batch``, ``lengths`` (``low``, ``high``, ``dist``
``uniform`` or ``log_uniform``), ``pool_batches``, ``bucket``,
``pad_value``, ``trace_seconds``, ``limits``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import compare
from benchmark.reference import train as ref_train
from vidsum_tpu_torch import config as vcfg
from vidsum_tpu_torch.models.pretrain import VIDEO_REP_DIM, PretrainModel
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.train import schedule as vschedule
from vidsum_tpu_torch.train import steps

FIRST_STEPS = 3


def model_config(config: dict) -> vcfg.ModelConfig:
    fields = {f.name for f in dataclasses.fields(vcfg.ModelConfig)}
    return vcfg.ModelConfig(**{k: v for k, v in config.items()
                               if k in fields})


def stratified_lengths(spec: dict, count: int) -> np.ndarray:
    """``count`` lengths at evenly spaced quantiles of the distribution, so
    every seed gets the same set of sizes."""
    u = (np.arange(count) + 0.5) / count
    lo, hi = spec["low"], spec["high"]
    if spec["dist"] == "log_uniform":
        vals = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif spec["dist"] == "uniform":
        vals = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.rint(vals).astype(np.int64)


@dataclasses.dataclass
class Batch:
    x: np.ndarray          # (B, N, in_features) f32, padded with pad_value
    y: np.ndarray          # targets (B, N) or video reps (B, 512)
    mask: np.ndarray       # (B, N) bool, True at padding
    lengths: np.ndarray    # (B,) true lengths


def batch_groups(traffic: dict) -> List[np.ndarray]:
    """The pool's batches of lengths: the stratified lengths dealt into
    batches by a fixed permutation, the same for every seed."""
    B, P = traffic["batch"], traffic["pool_batches"]
    lens = stratified_lengths(traffic["lengths"], B * P)
    lens = lens[np.random.default_rng(0).permutation(B * P)]
    return [lens[i * B:(i + 1) * B] for i in range(P)]


def make_pool(config: dict, traffic: dict, seed: int, device) -> List[Batch]:
    """The distinct padded batches of the window, made on ``device`` from
    the seed and kept in host memory. The seed permutes each batch's rows
    and draws the features, targets and video representations."""
    rng = np.random.default_rng(harness.sub_seed(seed, "pool"))
    gen = harness.device_generator(seed, "pool", device)
    F, bucket = config["in_features"], traffic["bucket"]
    pretrain = traffic["step"] == "pretrain"
    pool = []
    for lens in batch_groups(traffic):
        lens = lens[rng.permutation(len(lens))]
        B = len(lens)
        N = -(-int(lens.max()) // bucket) * bucket
        mask = torch.arange(N, device=device)[None, :] >= torch.as_tensor(
            lens, device=device)[:, None]
        x = torch.randn((B, N, F), generator=gen, device=device)
        x.masked_fill_(mask[..., None], traffic["pad_value"])
        if pretrain:
            y = torch.randn((B, VIDEO_REP_DIM), generator=gen, device=device)
        else:
            y = torch.rand((B, N), generator=gen, device=device)
            y.masked_fill_(mask, traffic["pad_value"])
        pool.append(Batch(x.cpu().numpy(), y.cpu().numpy(),
                          mask.cpu().numpy(), lens))
        del x, y, mask
    return pool


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = dev = torch.device(device)
        self.pretrain = traffic["step"] == "pretrain"
        mcfg = model_config(config)
        d = config["d_model"]
        extra = ({"video_transform": (VIDEO_REP_DIM, d)} if self.pretrain
                 else None)
        self.weights = harness.make_weights(config, seed, dev, extra)
        if self.pretrain:
            hp = config["pretrain"]
            pcfg = vcfg.PretrainConfig(**{
                k: hp[k] for k in ("lr", "weight_decay", "batch_size",
                                   "epochs", "warmup_epochs",
                                   "scheduler_samples", "sharpening_t",
                                   "center_weight", "repel_weight")})
            sched = vschedule.reference_pretrain_schedule(
                pcfg.lr, max(pcfg.scheduler_samples // pcfg.batch_size, 1),
                pcfg.warmup_epochs, pcfg.epochs)
            model = PretrainModel(mcfg, pcfg, device=dev)
            harness.load_weights(model, self.weights)
            trained = [("encoder." + n, p)
                       for n, p in model.encoder.named_parameters()]
            self.opt = steps.make_optimizer(trained, sched(0),
                                            pcfg.weight_decay)
            self.step_fn = steps.make_pretrain_step(
                mcfg, pcfg, sched, attn_impl=traffic["attn_impl"], device=dev)
            self.trained = [(n[len("encoder."):], p) for n, p in trained]
        else:
            hp = config["train"]
            model = SimNet(mcfg, device=dev)
            harness.load_weights(model, self.weights)
            self.opt = steps.make_optimizer(model, hp["lr"],
                                            hp["weight_decay"])
            self.step_fn = steps.make_finetune_step(
                mcfg, attn_impl=traffic["attn_impl"], device=dev)
            self.trained = list(model.named_parameters())
        self.model = model
        self.gen_seed = harness.sub_seed(seed, "dropout")
        self.gen = torch.Generator().manual_seed(self.gen_seed)
        self.pool = make_pool(config, traffic, seed, dev)
        self.first = self._first_steps()
        seen = {b.x.shape for b in self.pool[:FIRST_STEPS]}
        for b in self.pool[FIRST_STEPS:]:
            if b.x.shape not in seen:
                seen.add(b.x.shape)
                self._step(b)
        _sync(dev)

    def _step(self, b: Batch) -> torch.Tensor:
        out = self.step_fn(self.model, self.opt, b.x, b.y, b.mask, self.gen)
        return out[0] if self.pretrain else out

    def _first_steps(self) -> dict:
        start = {n: p.detach().clone() for n, p in self.trained}
        losses, grad = [], None
        for i in range(FIRST_STEPS):
            losses.append(self._step(self.pool[i]))
            if i == 0:
                # Adam's first moment after one step is (1 - beta1) times
                # the gradient it took; a leaf without one reads NaN
                nan = torch.tensor(float("nan"))
                grad = {n: (self.opt.state[p]["exp_avg"].norm() / 0.1
                            if "exp_avg" in self.opt.state.get(p, {})
                            else nan)
                        for n, p in self.trained}
        delta = {n: (p.detach() - start[n]).norm() for n, p in self.trained}
        return {"losses": [float(v) for v in losses],
                "grad": {n: float(v) for n, v in grad.items()},
                "delta": {n: float(v) for n, v in delta.items()}}

    def window(self, seconds: float, tracer) -> dict:
        order = np.random.default_rng(
            harness.sub_seed(self.seed, "order")).permutation(len(self.pool))
        enqueue: List[float] = []
        lengths: List[np.ndarray] = []
        traced: List[np.ndarray] = []
        _sync(self.dev)
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            b = self.pool[order[i % len(order)]]
            ts = time.perf_counter()
            self._step(b)
            enqueue.append(time.perf_counter() - ts)
            lengths.append(b.lengths)
            if tracer is not None and tracer.active:
                traced.append(b.lengths)
                if tracer.due():
                    tracer.stop()
            i += 1
        _sync(self.dev)
        window_s = time.perf_counter() - t0
        return {"kind": "train", "pretrain": self.pretrain, "attempted": i,
                "failed": 0, "steps": i, "window_s": window_s,
                "enqueue_s": enqueue,
                "lengths": np.concatenate(lengths) if lengths else [],
                "traced_steps": len(traced),
                "traced_lengths": (np.concatenate(traced) if traced
                                   else [])}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.opt, self.step_fn, self.trained
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, **kw) -> dict:
        """The reference's first three steps on the same inputs
        (``benchmark.reference.train.follow``)."""
        batches = [(b.x, b.y, b.mask) for b in self.pool[:FIRST_STEPS]]
        return ref_train.follow(self.config, self.traffic, self.weights,
                                batches, self.gen_seed, self.dev, **kw)

    def check(self) -> dict:
        self.release()
        numbers = compare.training(self.first, self.follow())
        return {k: {"value": numbers[k], "limit": limit}
                for k, limit in self.traffic["limits"].items()}
