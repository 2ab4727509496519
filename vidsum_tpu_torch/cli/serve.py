# ported from vidsum_tpu/cli/serve.py (one card; the msgpack checkpoint,
# multi-GPU serving and the recycling supervisor arrive with later slices)
"""Serving CLI: a micro-batching scoring service behind a local HTTP API.

Usage:
    python -m vidsum_tpu_torch.cli.serve --torch_ckpt model_mae.pth \
        --port 8080 [--max_batch 8] [--max_delay_ms 3] \
        [--attn int8_block --wire_dtype int8]

Clients POST ``.npz`` feature payloads to ``/summarize`` (see
``vidsum_tpu_torch/serve_http.py`` for the protocol). The service runs on
the CUDA card. The flags and their defaults are the JAX package's; three
of its options arrive with later slices and raise ``NotImplementedError``
naming them: ``--ckpt`` (the JAX package's msgpack checkpoint, whose reader
comes with the checkpoint module, slice 5), ``--devices`` > 1 (the
multi-GPU slice) and the worker-recycling supervisor
(``--recycle_after_mb`` / ``--recycle_after_requests``, slice 5).
"""

from __future__ import annotations

import argparse
import logging
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vidsum_tpu_torch serve")
    p.add_argument("--ckpt", default=None,
                   help="vidsum_tpu scorer checkpoint (msgpack; arrives "
                        "with the checkpoint module)")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference-trained SimNet .pth (loaded as is)")
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_delay_ms", type=float, default=3.0)
    p.add_argument("--budget", type=float, default=0.15)
    p.add_argument("--attn", default=None,
                   help="attention impl override (default: the fused block "
                        "kernels; 'int8_block' / 'int8_dense' score on the "
                        "lossy int8 route)")
    p.add_argument("--devices", type=int, default=1,
                   help="serve over the first N local cards (N > 1 arrives "
                        "with the multi-GPU slice)")
    p.add_argument("--long_threshold", type=int, default=None,
                   help="feature-row count above which a request takes the "
                        "sequence-parallel route (multi-GPU slice)")
    p.add_argument("--warmup", default="128,256,512",
                   help="comma-separated lengths to run once before "
                        "serving — the (bucket x batch) grid of each (empty "
                        "string to skip); the first launch of each kernel "
                        "builds it")
    p.add_argument("--max_queue_depth", type=int, default=256,
                   help="admission bound on in-flight requests; past it "
                        "submit rejects with 503 (bounds device memory)")
    p.add_argument("--max_request_len", type=int, default=None,
                   help="optional cap on feature rows per request "
                        "(default: the kernel-envelope caps only)")
    p.add_argument("--max_body_bytes", type=int, default=256 * 1024 * 1024,
                   help="HTTP payload cap (413 past it)")
    p.add_argument("--wire_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16", "int8"],
                   help="host->device feature wire. 'auto' (lossless) "
                        "matches compute_dtype; 'int8' (LOSSY) quarters the "
                        "f32 bytes via per-frame quantization, dequantised "
                        "on the card")
    p.add_argument("--wire_mode", default="rows",
                   choices=["rows", "coalesced"],
                   help="'rows': async per-request transfers; 'coalesced': "
                        "one stacked transfer per micro-batch. Scores are "
                        "bit-identical either way")
    p.add_argument("--rss_watermark_mb", type=float, default=None,
                   help="in-process load shedding: past this host RSS, "
                        "submits 503 with a (rate-limited) log")
    p.add_argument("--recycle_after_mb", type=float, default=None,
                   help="supervise and recycle the serving worker past this "
                        "RSS (arrives with the CLIs slice)")
    p.add_argument("--recycle_after_requests", type=int, default=None,
                   help="recycle the supervised worker after this many "
                        "admitted requests (arrives with the CLIs slice)")
    p.add_argument("--_worker_fd", type=int, default=None,
                   help=argparse.SUPPRESS)   # internal: supervised worker
    p.add_argument("--verbose", action="store_true")
    return p


def check_slice(args) -> None:
    """Raise ``NotImplementedError`` for the options later slices bring."""
    if (args.recycle_after_mb is not None
            or args.recycle_after_requests is not None
            or args._worker_fd is not None):
        raise NotImplementedError(
            "worker recycling (--recycle_after_mb / --recycle_after_requests)"
            " arrives with slice 5 (the CLIs)")
    if args.ckpt:
        raise NotImplementedError(
            "--ckpt (the JAX package's msgpack checkpoint) arrives with the "
            "checkpoint module in slice 5; pass --torch_ckpt")
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 arrives with the multi-GPU slice")


def main(argv=None) -> None:
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="[%(levelname)s] %(module)s - %(message)s",
                        level=logging.INFO)
    check_slice(args)
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.convert import load_torch_checkpoint
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.serve_http import make_server

    cfg = ModelConfig(d_model=args.d_model, num_heads=args.num_heads,
                      num_layers=args.num_layers)
    model = SimNet(cfg, generator=torch.Generator().manual_seed(0))
    if args.torch_ckpt:
        model.load_state_dict(load_torch_checkpoint(args.torch_ckpt))
    else:
        logging.warning("no checkpoint given — serving random weights")
    service = ScoringService(model, cfg, attn_impl=args.attn,
                             max_batch=args.max_batch,
                             max_delay_ms=args.max_delay_ms,
                             budget_ratio=args.budget,
                             max_queue_depth=args.max_queue_depth,
                             max_request_len=args.max_request_len,
                             rss_watermark_mb=args.rss_watermark_mb,
                             wire_dtype=args.wire_dtype,
                             wire_mode=args.wire_mode,
                             long_threshold=args.long_threshold)
    if args.warmup:
        lengths = [int(s) for s in args.warmup.split(",") if s]
        logging.info("warming up %s x batch grid...", lengths)
        t0 = time.monotonic()
        warmed = service.warmup(lengths=lengths)
        for n_b, b, dt in warmed:
            logging.info("  warmed (bucket=%d, batch=%d) in %.2fs", n_b, b,
                         dt)
        logging.info("warmup: %d shapes in %.1fs", len(warmed),
                     time.monotonic() - t0)
    server = make_server(service, host=args.host, port=args.port,
                         max_body_bytes=args.max_body_bytes)
    server.verbose = args.verbose
    logging.info("serving on http://%s:%d (POST /summarize, GET /stats)",
                 *server.server_address)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
