"""The PGL-SUM scorer's kernel and GEMM launches a forward: the program's
counters ``PGLSum.launches`` over ``PGLSum.forwards`` at the run's end (set-up
and window; every forward of the kernel route launches alike). A program
without the scorer or its counters gives nothing."""

UNIT = "launches"


def read(run):
    if run.record["kind"] != "serve":
        return None
    try:
        from vidsum_tpu_torch.models.pglsum import PGLSum
    except ImportError:
        return None
    forwards = getattr(PGLSum, "forwards", 0)
    launches = getattr(PGLSum, "launches", None)
    if not forwards or launches is None:
        return None
    return launches / forwards
