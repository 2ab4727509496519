# ported from vidsum_tpu/cli/serve.py
"""Serving CLI: a micro-batching scoring service behind a local HTTP API.

Usage:
    python -m vidsum_tpu_torch.cli.serve --ckpt model_mae.ckpt \
        --port 8080 [--max_batch 8] [--max_delay_ms 3] \
        [--attn int8_block --wire_dtype int8] [--recycle_after_mb 4000] \
        [--arch pglsum]

Clients POST ``.npz`` feature payloads to ``/summarize`` (see
``vidsum_tpu_torch/serve_http.py`` for the protocol). The service runs on
the CUDA card, at every d_model and head_dim the JAX package takes;
``main(argv, device="cpu")`` serves the plain PyTorch path
(a keyword of the function, not a flag). ``--ckpt`` takes a model
checkpoint of either package (the port's ``torch.save`` file, as
``cli.train`` writes it, or the JAX package's msgpack file), ``--torch_ckpt``
a reference-trained ``.pth``. The flags and their defaults are the JAX
package's. ``--devices N`` serves over a (1, N) ``DeviceMesh`` of the first
N visible cards (``ScoringService(mesh=)``: replica batches for short
requests, the sequence-parallel ring past ``--long_threshold``) and exits
with the JAX message where fewer cards are present; it never repeats a card.

**Worker recycling** (``--recycle_after_mb`` / ``--recycle_after_requests``):
the CLI runs as a supervisor that owns the listening socket and spawns the
serving worker (this module with ``--_worker_fd``) as a subprocess that
inherits it. When the worker crosses a threshold (its RSS, or the requests
its service admitted) it drains: it stops accepting, finishes every request
in flight, closes the service and exits with ``EXIT_RECYCLE``; the
supervisor then spawns a fresh worker on the same socket. Connections that
arrive during the handoff wait in the TCP backlog instead of being refused,
so no request is dropped. The supervisor imports no ``torch``, so only one
generation at a time holds the card's memory. ``--rss_watermark_mb`` arms
in-process load shedding (503s) besides.
"""

from __future__ import annotations

import argparse
import logging
import time

from vidsum_tpu_torch.cli import add_arch_argument, scorer_config

EXIT_RECYCLE = 42       # worker -> supervisor: drained for recycling
MAX_CRASHES = 5         # the supervisor gives up after this many in a row
CRASH_BACKOFF_S = 2.0   # pause before respawning a crashed worker
DRAIN_TIMEOUT_S = 120   # SIGINT drain of the worker before terminate()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vidsum_tpu_torch serve")
    p.add_argument("--ckpt", default=None,
                   help="model checkpoint of either package (the port's "
                        "torch.save file or the JAX package's msgpack)")
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
                   help="serve over the first N local cards (replica "
                        "batches + the sequence-parallel ring for long "
                        "requests)")
    p.add_argument("--long_threshold", type=int, default=None,
                   help="feature-row count above which a request takes the "
                        "sequence-parallel route (with --devices > 1)")
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
                   help="supervise a serving worker subprocess and recycle "
                        "it (drain in-flight requests, respawn on the same "
                        "listening socket) once its RSS passes this")
    p.add_argument("--recycle_after_requests", type=int, default=None,
                   help="recycle the supervised worker after this many "
                        "admitted requests (composable with "
                        "--recycle_after_mb; the first threshold wins)")
    p.add_argument("--_worker_fd", type=int, default=None,
                   help=argparse.SUPPRESS)   # internal: supervised worker
    p.add_argument("--verbose", action="store_true")
    add_arch_argument(p)
    return p


def serve_mesh(n: int, device=None):
    """The (1, n) mesh ``--devices n`` serves over: the first n visible
    cards, or exit with the JAX message where fewer are present; None for
    one device. With ``device="cpu"`` (the plain path) n entries of the
    CPU."""
    if n <= 1:
        return None
    import torch

    from vidsum_tpu_torch.parallel.mesh import make_mesh

    if device is not None and torch.device(device).type == "cpu":
        return make_mesh((1, n), "cpu")
    present = torch.cuda.device_count()
    if present < n:
        raise SystemExit(f"--devices {n} but only {present} present")
    return make_mesh((1, n), [f"cuda:{i}" for i in range(n)])


def load_model(args, cfg, device=None):
    """The scorer ``main`` serves: ``build_scorer(cfg)`` (``SimNet``, or
    ``PGLSum`` with ``--arch pglsum``) on ``device`` (default: the CUDA
    card) with the weights of ``--torch_ckpt`` or ``--ckpt`` (either
    package's format; a PGL-SUM state dict by its public names), or seeded
    random weights with a warning."""
    from vidsum_tpu_torch.models import build_scorer
    from vidsum_tpu_torch.models.convert import load_torch_checkpoint
    from vidsum_tpu_torch.train.checkpoint import load_model_state

    model = build_scorer(cfg, device=device)
    if args.torch_ckpt:
        model.load_state_dict(load_torch_checkpoint(args.torch_ckpt))
    elif args.ckpt:
        model.load_state_dict(load_model_state(args.ckpt)[0])
    else:
        logging.warning("no checkpoint given — serving random weights")
    return model


def make_service(args, cfg, model, device=None, mesh=None):
    """The ``ScoringService`` ``main`` serves, over ``model`` with the
    command line's batching, admission and wire options (and ``mesh``,
    :func:`serve_mesh`'s)."""
    from vidsum_tpu_torch.serve import ScoringService

    return ScoringService(model, cfg, attn_impl=args.attn,
                          max_batch=args.max_batch,
                          max_delay_ms=args.max_delay_ms,
                          budget_ratio=args.budget,
                          max_queue_depth=args.max_queue_depth,
                          max_request_len=args.max_request_len,
                          rss_watermark_mb=args.rss_watermark_mb,
                          wire_dtype=args.wire_dtype,
                          wire_mode=args.wire_mode,
                          mesh=mesh, long_threshold=args.long_threshold,
                          device=None if mesh is not None else device)


def recycling(args) -> bool:
    return (args.recycle_after_mb is not None
            or args.recycle_after_requests is not None)


def run_supervisor(args, argv) -> None:
    """Own the listening socket; spawn and respawn serving workers.

    The socket (``SO_REUSEADDR``, a backlog of 128) is inherited by every
    worker generation, so connections made during a handoff queue instead
    of being refused. A worker's ``EXIT_RECYCLE`` respawns it, 0 ends the
    supervisor, any other code counts as a crash: after ``MAX_CRASHES`` in a
    row the supervisor exits with the last code. On SIGINT it drains the
    worker (SIGINT, ``DRAIN_TIMEOUT_S``, then terminate). It never imports
    ``torch``: only the worker touches the card."""
    import signal
    import socket
    import subprocess
    import sys

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((args.host, args.port))
    sock.listen(128)   # deep backlog: it rides out the recycle handoff
    sock.set_inheritable(True)
    host, port = sock.getsockname()
    logging.info("supervisor: listening on http://%s:%d; recycling after "
                 "%s MB RSS / %s requests", host, port,
                 args.recycle_after_mb, args.recycle_after_requests)
    crashes = 0
    gen = 0
    try:
        while True:
            gen += 1
            cmd = ([sys.executable, "-m", "vidsum_tpu_torch.cli.serve"]
                   + list(argv) + ["--_worker_fd", str(sock.fileno())])
            t0 = time.monotonic()
            proc = subprocess.Popen(cmd, pass_fds=(sock.fileno(),))
            try:
                rc = proc.wait()
            except KeyboardInterrupt:
                proc.send_signal(signal.SIGINT)   # drain, then exit 0
                try:
                    proc.wait(timeout=DRAIN_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    proc.wait(timeout=30)
                break
            if rc == EXIT_RECYCLE:
                logging.info("supervisor: worker generation %d recycled "
                             "after %.1fs; respawning", gen,
                             time.monotonic() - t0)
                crashes = 0
                continue
            if rc == 0:
                logging.info("supervisor: worker exited cleanly; done")
                break
            crashes += 1
            logging.error("supervisor: worker generation %d died rc=%d "
                          "(crash %d/%d)", gen, rc, crashes, MAX_CRASHES)
            if crashes >= MAX_CRASHES:
                raise SystemExit(rc)
            time.sleep(CRASH_BACKOFF_S)
    finally:
        sock.close()


def start_recycle_monitor(args, service, server):
    """In a supervised worker: a thread that polls the service's admitted
    requests and the process's RSS every 0.5 s and, at the first threshold,
    shuts the server down (the handlers in flight finish). Returns the
    event it sets then."""
    import threading

    from vidsum_tpu_torch.serve.admission import process_rss_mb

    recycled = threading.Event()

    def monitor():
        while not recycled.is_set():
            n = service.stats().requests
            rss = process_rss_mb()
            if ((args.recycle_after_requests is not None
                 and n >= args.recycle_after_requests)
                    or (args.recycle_after_mb is not None
                        and rss >= args.recycle_after_mb)):
                logging.warning("worker: draining for recycle (%d requests, "
                                "RSS %.0f MB)", n, rss)
                recycled.set()
                server.shutdown()   # stop accepting; handlers finish
                return
            time.sleep(0.5)

    threading.Thread(target=monitor, daemon=True,
                     name="vidsum-recycle").start()
    return recycled


def main(argv=None, *, device=None) -> None:
    """Serve on ``device`` (default: the CUDA card). With a recycle
    threshold and no ``--_worker_fd`` this process is the supervisor
    (``run_supervisor``); with ``--_worker_fd`` it is a worker on the
    supervisor's socket and exits with ``EXIT_RECYCLE`` after a drain."""
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="[%(levelname)s] %(module)s - %(message)s",
                        level=logging.INFO)
    if recycling(args) and args._worker_fd is None:
        run_supervisor(args, argv)
        return
    from vidsum_tpu_torch.serve_http import make_server

    mesh = serve_mesh(args.devices, device)
    cfg = scorer_config(args)
    model = load_model(args, cfg, mesh.devices[0] if mesh else device)
    service = make_service(args, cfg, model, device, mesh)
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
    bound = None
    if args._worker_fd is not None:
        import socket

        # the supervisor's listening socket; handler threads are not
        # daemons, so server_close() joins every request in flight
        bound = socket.socket(fileno=args._worker_fd)
    server = make_server(service, host=args.host, port=args.port,
                         max_body_bytes=args.max_body_bytes,
                         bound_socket=bound,
                         daemon_threads=args._worker_fd is None)
    server.verbose = args.verbose
    recycled = (start_recycle_monitor(args, service, server)
                if bound is not None and recycling(args) else None)
    logging.info("serving on http://%s:%d (POST /summarize, GET /stats)",
                 *server.server_address)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()   # supervised: joins the handlers in flight
        service.close()
    if recycled is not None and recycled.is_set():
        raise SystemExit(EXIT_RECYCLE)


if __name__ == "__main__":
    main()
