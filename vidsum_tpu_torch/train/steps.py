# ported from vidsum_tpu/train/steps.py
"""The finetune step, the eval forward and the pretrain step.

- finetune step (reference ``src/train.py:111-131``): masked MSE over raw
  logits, Adam with torch-style coupled weight decay (``train.py:35-36``).
  The JAX step is one jitted program that donates params and optimizer
  state; here the step updates the model's parameters and the optimizer's
  state in place, which is what donation buys there.
- eval forward (reference ``src/train.py:134-152``): sigmoid scores.
- pretrain step (reference ``src/pretrain.py:54-70``): the three-loss
  objective with the config's weights, Adam over the encoder's parameters
  only when ``video_transform`` is frozen (``pretrain.py:35``), the learning
  rate of each update from the reference's schedule.

Both training steps move their host batches to the card through
:func:`move_batch`: staged in a two-slot ring of pinned buffers
(:class:`StagingRing`, one a step function) and copied without blocking.
While a profiler runs, each training step records a ``train.step`` span
tiled by ``train.transfer`` (the batch's move to the device) and
``train.compute`` (zero_grad, forward, losses, backward, Adam)
(``utils.profiling``).
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import torch

from vidsum_tpu_torch.config import ModelConfig, PretrainConfig
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.ops.losses import mse_with_mask_loss
from vidsum_tpu_torch.utils import profiling


def make_optimizer(params: Union[torch.nn.Module,
                                 Iterable[Tuple[str, torch.Tensor]]],
                   lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with coupled weight decay (grad += wd * param before the moment
    updates): the JAX package's ``optax.add_decayed_weights`` + ``adam``.
    ``params`` is a module (all its parameters) or a list of ``(name,
    parameter)`` pairs; the optimizer keeps the names (its state dict's
    ``param_names``), which ``train.checkpoint.adam_state_from_jax`` maps the
    JAX package's Adam state by."""
    named = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params)
    return torch.optim.Adam(list(named), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates ``optimizer`` has taken: its ``step`` (0 before
    the first), read from the state (a CPU tensor: no device sync)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


class StagingRing:
    """Pinned host buffers that training batches reach the card through:
    ``SLOTS`` slots, taken in turn, one a step. A slot holds one pinned
    byte buffer for each array of a step, grown to fit and never shrunk,
    and a CUDA event recorded after that step's copies. Taking a slot waits
    for its event, so a buffer is never overwritten while its copy is in
    flight, pinned memory stays at ``SLOTS`` steps' batches, and the host
    runs at most ``SLOTS`` steps ahead of the copies."""

    SLOTS = 2

    def __init__(self):
        self._bufs: List[Dict[int, torch.Tensor]] = [
            {} for _ in range(self.SLOTS)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._next = 0

    def take(self) -> int:
        """The next slot, once its last copies have finished."""
        slot, self._next = self._next, (self._next + 1) % self.SLOTS
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        return slot

    def buffer(self, slot: int, i: int, nbytes: int) -> torch.Tensor:
        """Slot ``slot``'s pinned byte buffer for array ``i``, at least
        ``nbytes`` long."""
        bufs = self._bufs[slot]
        if i not in bufs or bufs[i].numel() < nbytes:
            bufs[i] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return bufs[i]

    def record(self, slot: int, dev: torch.device) -> None:
        """Mark the slot's copies, just issued on ``dev``'s current stream."""
        if self._events[slot] is None:
            self._events[slot] = torch.cuda.Event()
        self._events[slot].record(torch.cuda.current_stream(dev))

    def held_bytes(self) -> int:
        """Pinned bytes the ring holds, over all slots."""
        return sum(b.numel() for bufs in self._bufs for b in bufs.values())


def move_batch(arrays: Sequence, dev: torch.device,
               ring: StagingRing) -> Tuple[torch.Tensor, ...]:
    """``arrays`` (numpy arrays or tensors) on ``dev``, each as
    ``torch.as_tensor(a).to(dev)`` gives it, without waiting for the stream:

    - to a device other than CUDA, or from a tensor not in host memory
      (already on ``dev``: itself), ``.to(dev)``;
    - from a pinned host tensor, a non-blocking copy (the caller keeps it
      unchanged until the step's work is done);
    - otherwise staged: copied on the host (``Tensor.copy_``, which runs on
      torch's intra-op threads without the GIL) into ``ring``'s next slot,
      then copied to ``dev`` without blocking on its current stream. The
      host copy ends before this returns, so the caller may overwrite its
      arrays at once.

    Counts arrays staged (``move_batch.staged``, their bytes
    ``move_batch.staged_bytes``) and moved otherwise (``move_batch.direct``).
    """
    ts = [torch.as_tensor(a) for a in arrays]
    out: List[Optional[torch.Tensor]] = [None] * len(ts)
    stage = []
    for i, t in enumerate(ts):
        if dev.type != "cuda" or t.device.type != "cpu":
            out[i] = t.to(dev)
        elif t.is_pinned():
            out[i] = t.to(dev, non_blocking=True)
        else:
            stage.append(i)
    move_batch.direct += len(ts) - len(stage)
    if stage:
        slot = ring.take()
        for i in stage:
            t = ts[i]
            nbytes = t.numel() * t.element_size()
            host = (ring.buffer(slot, i, nbytes)[:nbytes].view(t.dtype)
                    .view(t.shape))
            host.copy_(t)
            out[i] = host.to(dev, non_blocking=True)
            move_batch.staged += 1
            move_batch.staged_bytes += nbytes
        ring.record(slot, dev)
    return tuple(out)


move_batch.staged = 0
move_batch.staged_bytes = 0
move_batch.direct = 0


def make_finetune_step(cfg: ModelConfig, attn_impl: Optional[str] = None, *,
                       device=None) -> Callable:
    """Returns ``step(model, optimizer, x, target, pad_mask, generator,
    block_seeds=None, item_weight=None) -> loss`` (a 0-d tensor on
    ``device``, not synchronised). Inputs may be numpy arrays or tensors
    and move to ``device`` (default: the CUDA card, which must exist)
    through :func:`move_batch` and the step's :class:`StagingRing`
    (``step.staging``). ``attn_impl`` ``None`` or ``"auto"``
    (``TrainConfig.attn_impl``) means ``"fused_block"`` on CUDA and
    ``"dense"`` on the CPU. ``"fused_block"``
    demotes to ``"flash"`` past ``fused_block_train_supported`` (long
    videos), and ``"flash"`` trains through
    ``ops/attention_train.flash_attention_dropout`` at every length up to
    that route's envelope (``flash_train_supported``), past which it raises
    ``ValueError``. ``generator`` draws the dropout (see ``SimNet.forward``
    for ``block_seeds``). ``item_weight`` (B,) weighs the videos of a
    padded batch (``ops.losses.mse_with_mask_loss``). The step leaves the
    gradients in ``.grad``."""
    dev = resolve_device(device)
    if attn_impl in (None, "auto"):
        attn_impl = "fused_block" if dev.type == "cuda" else "dense"
    ring = StagingRing()

    def step(model, optimizer, x, target, pad_mask, generator,
             block_seeds: Optional[Sequence[int]] = None,
             item_weight=None):
        with profiling.span("train.step") as st:
            with profiling.span("train.transfer", st.id, st.id):
                x, target, pad_mask = move_batch((x, target, pad_mask), dev,
                                                 ring)
            with profiling.span("train.compute", st.id, st.id):
                optimizer.zero_grad(set_to_none=True)
                scores, _ = model(x, pad_mask, attn_impl=attn_impl,
                                  deterministic=False, generator=generator,
                                  block_seeds=block_seeds)
                loss = mse_with_mask_loss(scores, target, pad_mask,
                                          item_weight=item_weight)
                loss.backward()
                optimizer.step()
                return loss.detach()

    step.attn_impl = attn_impl
    step.staging = ring
    return step


def make_eval_forward(cfg: ModelConfig, attn_impl: Optional[str] = None, *,
                      device=None) -> Callable:
    """Returns ``fwd(model, x, pad_mask) -> sigmoid scores (B, N)`` (f32, on
    ``device``), the reference's val-time ``Sigmoid()(output)``
    (train.py:144). ``x`` and ``pad_mask`` may be numpy arrays or tensors;
    they move to ``device`` (default: the CUDA card, which must exist).
    ``attn_impl`` defaults to ``"fused_block"`` on CUDA and ``"dense"`` on
    the CPU; ``"int8_block"`` and ``"int8_dense"`` score on ``SimNet``'s
    lossy int8 route. ``model`` is either scorer (``models.build_scorer``):
    ``PGLSum`` maps ``"flash"`` and ``"fused_block"`` to its kernel
    route."""
    dev = resolve_device(device)
    if attn_impl is None:
        attn_impl = "fused_block" if dev.type == "cuda" else "dense"

    def fwd(model, x, pad_mask):
        with torch.inference_mode():
            x = torch.as_tensor(x).to(dev)
            if pad_mask is not None:
                pad_mask = torch.as_tensor(pad_mask).to(dev)
            scores, _ = model(x, pad_mask, attn_impl=attn_impl)
            return torch.sigmoid(scores[..., 0])

    fwd.attn_impl = attn_impl
    return fwd


def make_pretrain_step(model_cfg: ModelConfig, pretrain_cfg: PretrainConfig,
                       schedule: Callable[[int], float],
                       attn_impl: Optional[str] = None, *,
                       device=None) -> Callable:
    """Returns ``step(model, optimizer, x, video_rep, pad_mask, generator,
    block_seeds=None) -> tensor([total, main, center, repel])`` (on
    ``device``, not synchronised) for a
    :class:`~vidsum_tpu_torch.models.pretrain.PretrainModel`. Inputs may be
    numpy arrays or tensors and move to ``device`` (default: the CUDA card,
    which must exist) as the finetune step's do. ``attn_impl`` ``None``
    means ``"fused_block"`` on CUDA (TPU kernels 9-12 in every block,
    demoting to ``"flash"`` past their envelope) and ``"dense"`` on the
    CPU. Before ``optimizer.step()`` every
    parameter group's ``lr`` is set to ``schedule(update_count(optimizer))``,
    so a resumed optimizer continues the sequence. The optimizer holds only
    the parameters that train (``make_optimizer`` over the encoder's when
    ``video_transform`` is frozen), so the frozen ones keep their bits, weight
    decay included (the JAX step zeroes their updates instead)."""
    dev = resolve_device(device)
    if attn_impl in (None, "auto"):
        attn_impl = "fused_block" if dev.type == "cuda" else "dense"
    cw, rw = pretrain_cfg.center_weight, pretrain_cfg.repel_weight
    ring = StagingRing()

    def step(model, optimizer, x, video_rep, pad_mask, generator,
             block_seeds: Optional[Sequence[int]] = None):
        with profiling.span("train.step") as st:
            with profiling.span("train.transfer", st.id, st.id):
                x, video_rep, pad_mask = move_batch((x, video_rep, pad_mask),
                                                    dev, ring)
            with profiling.span("train.compute", st.id, st.id):
                optimizer.zero_grad(set_to_none=True)
                main, center, repel = model(x, video_rep, pad_mask,
                                            attn_impl=attn_impl,
                                            deterministic=False,
                                            generator=generator,
                                            block_seeds=block_seeds)
                total = main + cw * center + rw * repel
                total.backward()
                lr = schedule(update_count(optimizer))
                for group in optimizer.param_groups:
                    group["lr"] = lr
                optimizer.step()
                return torch.stack([total, main, center, repel]).detach()

    step.attn_impl = attn_impl
    step.staging = ring
    return step
