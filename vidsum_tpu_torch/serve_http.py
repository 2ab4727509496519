# ported from vidsum_tpu/serve_http.py
"""Minimal HTTP front-end for
:class:`vidsum_tpu_torch.serve.ScoringService`.

Stdlib-only (``http.server`` threading server) so the serving stack has no
dependencies beyond the framework itself. One process, one chip, one queue;
replicate behind any external load balancer for horizontal scale.

Protocol:

- ``POST /summarize`` — body is an ``.npz`` payload with ``features``
  (n, in_features) float32 and optionally ``picks`` (n,), ``n_frames``
  (scalar), ``change_points`` (S, 2). Query params: ``summary=0`` to skip
  shot selection, ``budget=0.15`` to override the knapsack budget ratio.
  Response JSON: ``scores`` (per input row), ``summary_frames`` (selected
  original-frame indices), ``change_points``, ``n_frames``,
  ``latency_s``.
- ``GET /healthz`` — liveness.
- ``GET /stats`` — the service's
  :class:`~vidsum_tpu_torch.serve.ServeStats`.

Admission control maps to HTTP statuses: payloads past ``max_body_bytes``
are refused with 413 before the body is read; the service's
:class:`~vidsum_tpu_torch.serve.ServiceOverloaded` (the ``max_queue_depth``
admission bound — what actually bounds in-flight work and device memory)
becomes 503 with a ``Retry-After`` hint; ``RequestTooLong`` 413;
``DeadlineExceeded`` (from the ``deadline`` query param, seconds) 504; any
unexpected scorer or kernel failure 500 with a JSON body rather than a
dropped connection.

Query params on ``POST /summarize``: ``summary=0`` to skip shot selection,
``budget=<float>`` knapsack budget ratio, ``deadline=<float>`` dispatch
deadline in seconds.
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from vidsum_tpu_torch.serve import (
    DeadlineExceeded, RequestTooLong, ScoringService, ServiceOverloaded,
)


class _Handler(BaseHTTPRequestHandler):
    # set by make_server on the server object
    server: "SummarizationHTTPServer"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _send_json(self, obj, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send_json({"ok": True})
        elif path == "/stats":
            self._send_json(dataclasses.asdict(self.server.service.stats()))
        else:
            self._send_json({"error": f"unknown path {path}"}, status=404)

    def do_POST(self):  # noqa: N802 — http.server API
        url = urlparse(self.path)
        if url.path != "/summarize":
            self._send_json({"error": f"unknown path {url.path}"}, status=404)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length > self.server.max_body_bytes:
                # refuse without BUFFERING the body (it never occupies
                # handler memory) — but do drain-and-discard it in chunks,
                # else the still-sending client hits a broken pipe before
                # it can read the 413. Grossly abusive declarations (>4×
                # cap) are not drained; the connection just closes.
                self.close_connection = True
                remaining = min(length, 4 * self.server.max_body_bytes)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self._send_json(
                    {"error": f"payload {length} bytes exceeds "
                              f"max_body_bytes={self.server.max_body_bytes}"},
                    status=413)
                return
            with np.load(io.BytesIO(self.rfile.read(length))) as z:
                if "features" not in z:
                    raise ValueError("npz payload must contain 'features'")
                feats = z["features"]
                picks = z["picks"] if "picks" in z else None
                n_frames = (int(z["n_frames"].reshape(())) if "n_frames" in z
                            else None)
                cps = z["change_points"] if "change_points" in z else None
            q = parse_qs(url.query)
            want_summary = q.get("summary", ["1"])[0] not in ("0", "false")
            budget = (float(q["budget"][0]) if "budget" in q else None)
            deadline = (float(q["deadline"][0]) if "deadline" in q else None)
            res = self.server.service.summarize(
                feats, picks=picks, n_frames=n_frames, change_points=cps,
                want_summary=want_summary, budget_ratio=budget,
                deadline_s=deadline)
        except ServiceOverloaded as e:
            self.send_response(503)
            body = json.dumps({"error": str(e)}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)
            return
        except RequestTooLong as e:
            self._send_json({"error": str(e)}, status=413)
            return
        except DeadlineExceeded as e:
            self._send_json({"error": str(e)}, status=504)
            return
        except (ValueError, KeyError, OSError) as e:
            self._send_json({"error": str(e)}, status=400)
            return
        except Exception as e:  # noqa: BLE001 — scorer/kernel/closed-service
            # failures become a JSON 500, never a dropped connection
            self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, status=500)
            return
        out = {
            "scores": np.asarray(res.scores, dtype=np.float64).tolist(),
            "n_frames": res.n_frames,
            "latency_s": res.latency_s,
        }
        if res.summary is not None:
            out["summary_frames"] = np.nonzero(res.summary)[0].tolist()
            out["change_points"] = res.change_points.tolist()
        self._send_json(out)


class SummarizationHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver defaults to listen(5); server_activate() re-listens on
    # an adopted socket, so a small value here would SHRINK the backlog a
    # supervisor gave it and drop SYNs during a worker handoff. Keep it at
    # least as deep as a supervisor's listen(128).
    request_queue_size = 128

    def __init__(self, addr, service: ScoringService, verbose: bool = False,
                 max_body_bytes: int = 256 * 1024 * 1024,
                 bound_socket=None, daemon_threads: bool = True):
        self.service = service
        self.verbose = verbose
        self.max_body_bytes = int(max_body_bytes)
        # instance attr shadows the class default: supervised workers set
        # daemon_threads=False so server_close() JOINS in-flight handler
        # threads — a drain-for-recycle finishes every accepted request
        # before the process exits
        self.daemon_threads = bool(daemon_threads)
        if bound_socket is None:
            super().__init__(addr, _Handler)
        else:
            # adopt a pre-bound listening socket (inherited from the
            # supervisor): the supervisor keeps the fd open across worker
            # generations, so connections queue in the TCP backlog during
            # a recycle instead of being refused
            super().__init__(addr, _Handler, bind_and_activate=False)
            self.socket.close()
            self.socket = bound_socket
            self.server_address = bound_socket.getsockname()
            self.server_activate()


def make_server(service: ScoringService, host: str = "127.0.0.1",
                port: int = 0,
                max_body_bytes: int = 256 * 1024 * 1024,
                bound_socket=None, daemon_threads: bool = True
                ) -> SummarizationHTTPServer:
    """Bind (port 0 = ephemeral; read ``server.server_address``). Call
    ``serve_forever()`` or drive it from a thread (tests do the latter).
    ``max_body_bytes`` caps ``POST /summarize`` payloads (413 past it; the
    256 MiB default comfortably fits a 160k-row float32 flagship payload).
    ``bound_socket`` adopts an existing listening socket instead of
    binding (supervised-worker mode); ``daemon_threads=False`` makes
    ``server_close()`` join in-flight handlers (graceful drain)."""
    return SummarizationHTTPServer((host, port), service,
                                   max_body_bytes=max_body_bytes,
                                   bound_socket=bound_socket,
                                   daemon_threads=daemon_threads)


def run_in_thread(server: SummarizationHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="vidsum-http")
    t.start()
    return t
