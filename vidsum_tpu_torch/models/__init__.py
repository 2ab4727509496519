"""Port of the corresponding vidsum_tpu subpackage, and the scorers the
port adds (``pglsum``)."""


def build_scorer(cfg, device=None, generator=None):
    """The scorer ``cfg.arch`` names, on ``device`` (default: the CUDA
    card), initialised from ``generator`` (default: seed 0):
    :class:`~vidsum_tpu_torch.models.simnet.SimNet` for ``"simnet"``,
    :class:`~vidsum_tpu_torch.models.pglsum.PGLSum` for ``"pglsum"``."""
    if cfg.arch == "simnet":
        from vidsum_tpu_torch.models.simnet import SimNet

        return SimNet(cfg, device=device, generator=generator)
    if cfg.arch == "pglsum":
        from vidsum_tpu_torch.models.pglsum import PGLSum

        return PGLSum(cfg, device=device, generator=generator)
    raise ValueError(f"unknown scorer architecture {cfg.arch!r}")
