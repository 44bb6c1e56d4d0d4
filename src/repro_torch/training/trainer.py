"""Training loop: the loss's gradient by autograd and an AdamW step.

The counterpart of the JAX package's ``training/trainer.py``. The step is
eager (there is nothing to ``jit``); the model's forward takes the
parameters explicitly, so the trainer differentiates its own leaves and
never touches the frozen parameters the model was built with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.models.api import param_shapes
from repro_torch.models.transformer import draw_params
from repro_torch.training.data import TokenDataset, make_train_batch
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_adamw)
from repro_torch.training.tree import flatten, unflatten


def make_train_step(model, opt_cfg: AdamWConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    stats)``: ``model.loss`` and its gradient with respect to every leaf
    of ``params``, then :func:`adamw_update`; ``stats`` holds ``loss``,
    ``grad_norm`` and ``lr`` (0-dim tensors on the parameters' device)."""
    def train_step(params: Dict, opt_state: Dict, batch: Dict):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten(params).items()}
        loss = model.loss(unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        params, opt_state, stats = adamw_update(
            opt_cfg, params, unflatten(dict(zip(leaves, grads))), opt_state)
        stats["loss"] = loss.detach()
        return params, opt_state, stats

    return train_step


@dataclasses.dataclass
class Trainer:
    """Trains ``model`` on :class:`TokenDataset` batches of ``batch_size``
    x ``seq_len`` tokens (plus encoder inputs for an encoder-decoder), on
    the device of the model's weights. ``step(params, opt_state, batch)``
    is one step of :func:`make_train_step` on a batch of :meth:`batch`."""
    model: object
    opt_cfg: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    batch_size: int = 8
    seq_len: int = 64

    def __post_init__(self):
        self.dataset = TokenDataset(self.model.cfg.vocab_size)
        self.device = next(self.model.parameters()).device
        self.step = make_train_step(self.model, self.opt_cfg)

    def init(self, seed: int = 0):
        """Fresh fp32 master weights drawn on the model's device from a
        ``torch.Generator`` seeded ``seed``, and a zeroed AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = draw_params(param_shapes(self.model.cfg), torch.float32,
                             generator=gen, device=self.device)
        return params, init_adamw(params)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The ``step``-th batch (the JAX package's numbers) on the
        device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in make_train_batch(
                    self.model.cfg, self.batch_size, self.seq_len, step,
                    self.dataset).items()}

    def run(self, params: Dict, opt_state: Dict, n_steps: int,
            log_every: int = 10, log: Optional[Callable] = print,
            start: int = 0):
        """``n_steps`` steps on batches ``start, start + 1, ...`` (a
        resumed run passes the step it resumes at). Returns ``(params,
        opt_state, losses)``."""
        losses = []
        t0 = time.time()
        for i, step in enumerate(range(start, start + n_steps)):
            params, opt_state, stats = self.step(params, opt_state,
                                                 self.batch(step))
            losses.append(float(stats["loss"]))
            if log and step % log_every == 0:
                log(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"lr {float(stats['lr']):.2e} "
                    f"gnorm {float(stats['grad_norm']):.3f} "
                    f"({(time.time()-t0)/(i+1)*1000:.0f} ms/step)")
        return params, opt_state, losses
