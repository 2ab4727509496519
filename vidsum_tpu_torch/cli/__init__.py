"""Command-line entry points of the port (``python -m
vidsum_tpu_torch.cli.<name>``).

The scoring CLIs (``serve``, ``evaluate``, ``summarize``) take the JAX
package's flags and one of the port's own, ``--arch``: ``simnet`` (the
default, sized by ``--d_model``, ``--num_heads``, ``--num_layers``) or
``pglsum`` (PGL-SUM at its published settings, ``config.pglsum_config``;
the width flags are not read)."""

from vidsum_tpu_torch.config import ARCHS


def add_arch_argument(p) -> None:
    p.add_argument("--arch", default="simnet", choices=ARCHS,
                   help="the scorer: simnet (sized by --d_model, "
                        "--num_heads, --num_layers) or pglsum (PGL-SUM as "
                        "published; a --ckpt with its public state-dict "
                        "names loads by name)")


def scorer_config(args, **fields):
    """The ``ModelConfig`` of the scorer ``args`` name, with ``fields``."""
    from vidsum_tpu_torch.config import ModelConfig, pglsum_config

    if args.arch == "pglsum":
        return pglsum_config(**fields)
    return ModelConfig(d_model=args.d_model, num_heads=args.num_heads,
                       num_layers=args.num_layers, **fields)
