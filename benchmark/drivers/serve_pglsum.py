"""Driver of the PGL-SUM serving cell: ``serve_loop``'s closed loop of
waiting clients in front of the port's ``ScoringService``, with a
``PGLSum`` scorer (``vidsum_tpu_torch.models.pglsum``) and the plain PGL-SUM
reference (``reference/pglsum.py``) for the check.

Set-up draws the weights from the seed under the public state-dict names
(``make_weights``), builds the scorer and the service, and then deals the
requests and warms the buckets as ``serve_loop.Session`` does; the window,
the sample and the check are ``serve_loop``'s. Traffic keys: those of
``serve_loop``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import serve_loop
from benchmark.drivers.train_step import model_config, stratified_lengths
from benchmark.reference import pglsum as ref_pglsum
from vidsum_tpu_torch.models.pglsum import PGLSum
from vidsum_tpu_torch.serve import service as vservice


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights on ``device`` from one uniform draw of a generator there,
    in the public module order: each Linear's weight (and bias, where it
    has one) U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the LayerNorms ones and
    zeros."""
    shapes = ref_pglsum.param_shapes(cfg)
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = harness.device_generator(seed, "weights", device)
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, off, fan_in = {}, 0, {}
    for name, shape in shapes.items():
        size = int(np.prod(shape))
        part = flat[off:off + size].view(shape)
        off += size
        base = name.rsplit(".", 1)[0]
        if base.startswith("norm_"):
            out[name] = (torch.ones(shape, device=device)
                         if name.endswith("weight")
                         else torch.zeros(shape, device=device))
            continue
        if name.endswith("weight"):
            fan_in[base] = shape[1]
        out[name] = (part * fan_in[base] ** -0.5).contiguous()
    return out


class Session(serve_loop.Session):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = dev = torch.device(device)
        self.weights = make_weights(config, seed, dev)
        mcfg = model_config(config)
        model = PGLSum(mcfg, device=dev)
        model.load_state_dict(self.weights)
        self.svc = vservice.ScoringService(
            model, mcfg, device=dev, bucket=traffic["bucket"],
            budget_ratio=config["eval"]["budget_ratio"],
            **traffic["service"])
        self.reference = None
        # the requests and the warm-up: serve_loop.Session's
        spec = traffic["lengths"]
        self.lengths = stratified_lengths(spec, spec["count"])
        rng = np.random.default_rng(harness.sub_seed(seed, "requests"))
        stride = traffic["frame_stride"]
        self.cps = [serve_loop.change_points(
            stride * n, max(n // traffic["shot_samples"], 1), rng)
            for n in self.lengths]
        gen = harness.device_generator(seed, "pool", dev)
        self.pool = [torch.randn((spec["high"], config["in_features"]),
                                 generator=gen, device=dev).cpu().numpy()
                     for _ in range(traffic["pool_videos"])]
        C = traffic["clients"]
        self.orders = [rng.permutation(len(self.lengths)) for _ in range(C)]
        self.sources = rng.integers(0, 2**62, size=(C, len(self.lengths)))
        buckets = sorted({-(-int(n) // traffic["bucket"]) * traffic["bucket"]
                          for n in self.lengths})
        self.svc.warmup(lengths=buckets, batch_sizes=[1, 2])
        self.svc.warmup(lengths=buckets[-1:],
                        batch_sizes=[4, traffic["service"]["max_batch"]])
        feats, picks, n_frames, cps, _ = self.request(0, 0)
        self.svc.submit(feats, picks=picks, n_frames=n_frames,
                        change_points=cps).result()
        self.svc.reset_stats()

    def reference_scores(self, i: int, tf32: bool = False) -> np.ndarray:
        """The plain PGL-SUM's sigmoid scores of finished request ``i``,
        from the features it was sent, alone (``tf32``: the control's
        precision)."""
        if self.reference is None:
            self.reference = ref_pglsum.build(self.config, self.weights,
                                              self.dev)
        video, off, n, _ = self.results[i][3]
        x = torch.as_tensor(self.pool[video][off:off + n], device=self.dev)
        return ref_pglsum.scores(self.reference, x, tf32=tf32).cpu().numpy()
