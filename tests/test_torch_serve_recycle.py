"""The serving CLI's worker recycling on the CPU: a supervised worker run in
process (``main(..., device="cpu")`` on an adopted socket) answers every
request and exits with ``EXIT_RECYCLE`` after its threshold; the
supervisor's loop with ``subprocess.Popen`` replaced by a fake (the worker
command line, the inherited socket, respawns, the crash limit, the drain on
SIGINT) imports no ``torch``; and the HTTP server serves on a socket it did
not bind. The supervisor spawning real workers on the card is
``tests/test_torch_cuda.py::test_supervised_recycle_on_the_card``."""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models import init_simnet
from vidsum_tpu_torch.cli import serve as cli
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.models.convert import params_from_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.serve import ScoringService
from vidsum_tpu_torch.serve_http import make_server, run_in_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI builds ModelConfig(in_features=1024)
SMALL = ["--d_model", "32", "--num_heads", "4", "--num_layers", "1",
         "--max_delay_ms", "0", "--warmup", ""]


def _listening():
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    sock.listen(16)
    return sock


def _post(port, feats):
    buf = io.BytesIO()
    np.savez(buf, features=feats)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/summarize?summary=0", data=buf.getvalue(),
        method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_worker_answers_then_exits_for_recycle():
    """A worker on the supervisor's socket with --recycle_after_requests 2
    answers both requests, drains and raises SystemExit(EXIT_RECYCLE); its
    server closed the adopted socket."""
    sock = _listening()
    port = sock.getsockname()[1]
    fd = sock.detach()   # the worker adopts the descriptor
    ended = []

    def worker():
        try:
            cli.main(SMALL + ["--_worker_fd", str(fd),
                              "--recycle_after_requests", "2"], device="cpu")
            ended.append(None)
        except SystemExit as e:
            ended.append(e.code)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    feats = np.random.default_rng(2).normal(size=(60, 1024)).astype(
        np.float32)
    for _ in range(2):
        assert len(_post(port, feats)["scores"]) == 60
    t.join(timeout=60)
    assert not t.is_alive() and ended == [cli.EXIT_RECYCLE]
    with pytest.raises(OSError):
        os.fstat(fd)


class FakeWorker:
    """``subprocess.Popen`` for ``run_supervisor``: records the command,
    checks that the socket is inherited and listening, and returns the next
    scripted exit code (an exception is raised instead)."""

    spawned, script, signals = [], [], []

    def __init__(self, cmd, pass_fds=()):
        fd = int(cmd[-1])
        assert cmd[-2] == "--_worker_fd" and pass_fds == (fd,)
        assert os.get_inheritable(fd)
        with socket.socket(fileno=os.dup(fd)) as dup:
            addr = dup.getsockname()
        socket.create_connection(addr, timeout=5).close()   # queued
        self.spawned.append(cmd)
        self.rc = self.script.pop(0)

    def wait(self, timeout=None):
        rc, self.rc = self.rc, 0
        if isinstance(rc, BaseException):
            raise rc
        return rc

    def send_signal(self, sig):
        self.signals.append(sig)

    def terminate(self):
        self.signals.append("terminate")


@pytest.fixture
def fake_popen(monkeypatch):
    FakeWorker.spawned, FakeWorker.script, FakeWorker.signals = [], [], []
    monkeypatch.setattr(subprocess, "Popen", FakeWorker)
    monkeypatch.setattr(cli, "CRASH_BACKOFF_S", 0.0)
    return FakeWorker


ARGV = ["--host", "127.0.0.1", "--port", "0", "--recycle_after_requests",
        "4"] + SMALL


def test_supervisor_respawns_on_recycle_until_a_clean_exit(fake_popen):
    """Exit codes 42, 42, 0: three generations of the worker command line
    (this module, the user's flags, the inherited socket's descriptor),
    each on the same listening socket; the supervisor returns after 0."""
    fake_popen.script = [cli.EXIT_RECYCLE, cli.EXIT_RECYCLE, 0]
    cli.main(ARGV)
    assert len(fake_popen.spawned) == 3
    head = [sys.executable, "-m", "vidsum_tpu_torch.cli.serve", *ARGV,
            "--_worker_fd"]
    assert all(cmd[:-1] == head for cmd in fake_popen.spawned)
    assert len({cmd[-1] for cmd in fake_popen.spawned}) == 1
    assert fake_popen.script == []


@pytest.mark.parametrize("script,spawns,code", [
    ([1, 1, 1, 1, 1], 5, 1),
    ([3, 3, 3, 3, cli.EXIT_RECYCLE, 3, 3, 3, 3, 0], 10, None),
], ids=["gives_up", "recycle_resets_the_count"])
def test_supervisor_crash_limit(fake_popen, script, spawns, code):
    """Five crashes in a row end the supervisor with the worker's code; a
    recycle in between resets the count."""
    fake_popen.script = list(script)
    if code is None:
        cli.main(ARGV)
    else:
        with pytest.raises(SystemExit) as ei:
            cli.main(ARGV)
        assert ei.value.code == code
    assert len(fake_popen.spawned) == spawns


@pytest.mark.parametrize("drain", ["exits", "times_out"])
def test_supervisor_drains_the_worker_on_sigint(fake_popen, monkeypatch,
                                                drain):
    """Ctrl-C in the supervisor sends the worker SIGINT and waits
    DRAIN_TIMEOUT_S for it; past that it terminates the worker."""
    waits = []
    real_wait = FakeWorker.wait

    def wait(self, timeout=None):
        waits.append(timeout)
        if timeout == cli.DRAIN_TIMEOUT_S and drain == "times_out":
            raise subprocess.TimeoutExpired("worker", timeout)
        return real_wait(self, timeout)

    monkeypatch.setattr(FakeWorker, "wait", wait)
    fake_popen.script = [KeyboardInterrupt()]
    cli.main(ARGV)
    assert len(fake_popen.spawned) == 1
    if drain == "exits":
        assert fake_popen.signals == [signal.SIGINT]
        assert waits == [None, cli.DRAIN_TIMEOUT_S]
    else:
        assert fake_popen.signals == [signal.SIGINT, "terminate"]
        assert waits == [None, cli.DRAIN_TIMEOUT_S, 30]


def test_supervisor_imports_no_torch():
    """The supervisor process never imports torch (so it never holds the
    card): main() with a recycle flag and a worker that exits 0 at once."""
    code = ("import subprocess, sys\n"
            "class P:\n"
            "    def __init__(self, cmd, pass_fds=()): pass\n"
            "    def wait(self, timeout=None): return 0\n"
            "subprocess.Popen = P\n"
            "from vidsum_tpu_torch.cli import serve\n"
            "serve.main(['--port', '0', '--recycle_after_mb', '4000'])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_http_server_adopts_prebound_socket():
    """make_server(bound_socket=...) serves on a socket it did not bind and
    keeps a backlog at least as deep as the supervisor's (the counterpart
    of tests/test_serve_recycle.py's test)."""
    kw = dict(in_features=32, d_model=64, num_heads=4, num_layers=1,
              max_len=512)
    params = init_simnet(jax.random.PRNGKey(0),
                         JaxModelConfig(dropout=0.0, **kw))
    cfg = ModelConfig(dropout=0.0, **kw)
    model = SimNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    sock = _listening()
    host, port = sock.getsockname()
    feats = np.random.default_rng(1).normal(size=(40, 32)).astype(np.float32)
    with ScoringService(model, cfg, max_delay_ms=0.0, device="cpu") as svc:
        server = make_server(svc, bound_socket=sock, daemon_threads=False)
        assert server.server_address == (host, port)
        assert server.request_queue_size >= 64
        run_in_thread(server)
        try:
            assert len(_post(port, feats)["scores"]) == 40
        finally:
            server.shutdown()
            server.server_close()
