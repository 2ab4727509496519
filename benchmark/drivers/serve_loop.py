"""Driver of the serving cells: a closed loop of clients in front of the
port's ``serve.service.ScoringService``, each submitting a video's features
and waiting for its ``ServeResult`` (scores and summary) before it sends the
next, as ingest workers of a video archive do.

Every seed gets the same set of request lengths (``count`` evenly spaced
quantiles of the length distribution); the seed deals each client its own
order of them, draws the features (slices of a pool of videos made on the
device and kept in host memory) and the shots. A request of ``n`` feature
rows stands for ``frame_stride * n`` frames sampled every ``frame_stride``
(the DSNet layout: ``picks = stride * i``), with change points given, one
shot per ``shot_samples`` rows on average.

Traffic keys: ``clients``, ``lengths`` (``low``, ``high``, ``dist``,
``count``), ``frame_stride``, ``shot_samples``, ``pool_videos``,
``service`` (keyword arguments of ``ScoringService``), ``bucket``,
``sample_checked``, ``trace_seconds``, ``limits``.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers.train_step import model_config, stratified_lengths
from benchmark.reference import compare
from benchmark.reference import simnet as ref_simnet
from benchmark.reference import summary as ref_summary
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.serve import service as vservice


def change_points(n_frames: int, shots: int,
                  rng: np.random.Generator) -> np.ndarray:
    """(shots, 2) inclusive bounds of shots cut at distinct random frames."""
    cuts = np.sort(rng.choice(np.arange(1, n_frames), size=shots - 1,
                              replace=False))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts - 1, [n_frames - 1]])
    return np.stack([starts, ends], axis=1).astype(np.int64)


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = dev = torch.device(device)
        self.weights = harness.make_weights(config, seed, dev)
        mcfg = model_config(config)
        model = SimNet(mcfg, device=dev)
        harness.load_weights(model, self.weights)
        self.svc = vservice.ScoringService(
            model, mcfg, device=dev, bucket=traffic["bucket"],
            budget_ratio=config["eval"]["budget_ratio"],
            **traffic["service"])
        spec = traffic["lengths"]
        self.lengths = stratified_lengths(spec, spec["count"])
        rng = np.random.default_rng(harness.sub_seed(seed, "requests"))
        stride = traffic["frame_stride"]
        self.cps = [change_points(stride * n,
                                  max(n // traffic["shot_samples"], 1), rng)
                    for n in self.lengths]
        gen = harness.device_generator(seed, "pool", dev)
        self.pool = [torch.randn((spec["high"], config["in_features"]),
                                 generator=gen, device=dev).cpu().numpy()
                     for _ in range(traffic["pool_videos"])]
        C = traffic["clients"]
        self.orders = [rng.permutation(len(self.lengths)) for _ in range(C)]
        self.sources = rng.integers(0, 2**62, size=(C, len(self.lengths)))
        # every length bucket of the cell, one and two rows a batch; the
        # selection path (its native library) once
        buckets = sorted({-(-int(n) // traffic["bucket"]) * traffic["bucket"]
                          for n in self.lengths})
        self.svc.warmup(lengths=buckets, batch_sizes=[1, 2])
        self.svc.warmup(lengths=buckets[-1:],
                        batch_sizes=[4, traffic["service"]["max_batch"]])
        feats, picks, n_frames, cps, _ = self.request(0, 0)
        self.svc.submit(feats, picks=picks, n_frames=n_frames,
                        change_points=cps).result()
        self.svc.reset_stats()

    def request(self, client: int, k: int):
        """Client ``client``'s ``k``-th request: (features, picks, n_frames,
        change points, (pool video, offset, rows, length index))."""
        li = int(self.orders[client][k % len(self.lengths)])
        n = int(self.lengths[li])
        src = int(self.sources[client][k % len(self.lengths)] + k)
        video = src % len(self.pool)
        off = (src // len(self.pool)) % (self.pool[video].shape[0] - n + 1)
        stride = self.traffic["frame_stride"]
        feats = self.pool[video][off:off + n]
        picks = np.arange(n, dtype=np.int64) * stride
        return feats, picks, stride * n, self.cps[li], (video, off, n, li)

    def window(self, seconds: float, tracer) -> dict:
        C = self.traffic["clients"]
        stop = threading.Event()
        done: List[list] = [[] for _ in range(C)]
        errors: List[list] = [[] for _ in range(C)]

        def client(c: int):
            k = 0
            while not stop.is_set():
                feats, picks, n_frames, cps, src = self.request(c, k)
                ts = time.perf_counter()
                try:
                    fut = self.svc.submit(feats, picks=picks,
                                          n_frames=n_frames,
                                          change_points=cps)
                    te = time.perf_counter()
                    res = fut.result(timeout=120)
                except Exception as e:  # noqa: BLE001 — counted as failed
                    errors[c].append(repr(e))
                    k += 1
                    continue
                done[c].append((ts, te, time.perf_counter(), src, res))
                k += 1

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(C)]
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        trace_end = t0
        if tracer is not None:
            time.sleep(max(0.0, min(tracer.seconds, seconds)
                           - (time.perf_counter() - t0)))
            trace_end = time.perf_counter()
            tracer.stop()
        time.sleep(max(0.0, seconds - (time.perf_counter() - t0)))
        t_end = time.perf_counter()
        stats = self.svc.stats()
        stop.set()
        for t in threads:
            t.join(timeout=180)
        self.svc.close()
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a serving client did not finish")
        reqs = [r for c in range(C) for r in done[c]]
        in_window = [r for r in reqs if r[2] <= t_end]
        traced = [r for r in reqs if r[0] >= t0 and r[2] <= trace_end]
        self.results = reqs
        self.lost = sum(map(len, errors))
        return {"kind": "serve", "window_s": t_end - t0,
                "attempted": len(reqs) + self.lost, "failed": self.lost,
                "lengths": [r[3][2] for r in in_window],
                "latency_s": [r[2] - r[0] for r in in_window],
                "submit_s": [r[1] - r[0] for r in in_window],
                "traced_lengths": [r[3][2] for r in traced],
                "batches": stats.batches, "rows_scored": stats.rows_scored}

    def release(self) -> None:
        del self.svc
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """Indices of the finished requests the check compares: drawn from
        the seed, and the longest."""
        reqs = self.results
        rng = np.random.default_rng(harness.sub_seed(self.seed, "sample"))
        take = min(self.traffic["sample_checked"], len(reqs))
        idx = set(rng.choice(len(reqs), size=take, replace=False).tolist())
        if reqs:
            idx.add(max(range(len(reqs)), key=lambda i: reqs[i][3][2]))
        return sorted(idx)

    def reference_scores(self, i: int, tf32: bool = False) -> np.ndarray:
        """The reference's sigmoid scores of finished request ``i``, from
        the features it was sent (``tf32``: the control's precision)."""
        video, off, n, _ = self.results[i][3]
        x = torch.as_tensor(self.pool[video][off:off + n],
                            device=self.dev)[None]
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with torch.no_grad():
                logits, _ = ref_simnet.forward(
                    self.weights, self.config, x,
                    torch.zeros((1, n), dtype=torch.bool, device=self.dev))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
        return torch.sigmoid(logits[0]).cpu().numpy()

    def summary_wrong(self, i: int) -> bool:
        """Whether request ``i``'s served summary differs from the one the
        reference selects from its served scores."""
        _, _, _, (_, _, n, li), res = self.results[i]
        stride = self.traffic["frame_stride"]
        want = ref_summary.summary(
            res.scores, self.cps[li], stride * n,
            np.arange(n, dtype=np.int64) * stride,
            self.config["eval"]["budget_ratio"])
        return res.summary is None or not np.array_equal(want, res.summary)

    def check(self) -> dict:
        """The sample's served scores beside the reference's, and its
        served summaries beside the reference's selection."""
        self.release()
        idx = self.sample()
        gaps = [float(np.abs(self.results[i][4].scores
                             - self.reference_scores(i)).max())
                for i in idx]
        wrong = sum(self.summary_wrong(i) for i in idx)
        limits = self.traffic["limits"]
        return {"scores": {"value": compare.worst(gaps),
                           "limit": limits["scores"]},
                "summaries": {"value": wrong, "limit": limits["summaries"]},
                "lost": {"value": self.lost, "limit": 0}}
