"""The dense optimizers: adam, sgd and adagrad in optax's forms.

Counterpart of make_dense_optimizer (paddlebox_tpu/train/trainer.py:
419-427), which builds optax.adam, optax.sgd or optax.adagrad at
TrainerConfig.dense_lr:

  * adam: torch.optim.Adam (b1 0.9, b2 0.999, eps 1e-8), optax.adam's
    update, both states starting at zero;
  * sgd: torch.optim.SGD, p - lr * g as optax.sgd (no momentum, no state);
  * adagrad: ``OptaxAdagrad``, written here in optax's form
    (optax/_src/transform.py scale_by_rss, then scale_by_learning_rate;
    ``adagrad_update_``): the accumulator starts at ADAGRAD_INITIAL_ACC
    (0.1), acc += g^2, p += -lr * (g * rsqrt(acc + ADAGRAD_EPS)) with
    ADAGRAD_EPS 1e-7, and the step is 0 where acc <= 0.
    torch.optim.Adagrad puts eps outside the root (g / (sqrt(acc) + eps))
    and does not give this update even with initial_accumulator_value=0.1.

``opt_state_to_numpy`` / ``opt_state_from_numpy`` carry each optimizer's
state under optax's names (convert.py): a state written under one
optimizer refuses to load under another.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch

from paddlebox_tpu_torch.config.configs import TrainerConfig
from paddlebox_tpu_torch.convert import (ADAGRAD_EPS, ADAGRAD_INITIAL_ACC,
                                         adagrad_state_from_numpy,
                                         adagrad_state_to_numpy,
                                         adam_state_from_numpy,
                                         adam_state_to_numpy)

# the optax state's fields of each optimizer, as opt_state_to_numpy gives
# them
STATE_FIELDS = {"adam": ("count", "mu", "nu"), "sgd": (),
                "adagrad": ("sum_of_squares",)}


def adagrad_update_(p: torch.Tensor, g: torch.Tensor, acc: torch.Tensor,
                    lr: float) -> None:
    """One optax.adagrad step in place: acc += g^2, p += -lr * (g *
    rsqrt(acc + eps)), no step where acc <= 0 (optax's where(acc > 0))."""
    acc.add_(g * g)
    inv = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS),
                      torch.zeros_like(acc))
    p.add_((inv * g) * (-lr))


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad(lr): per parameter an accumulator ``sum_of_squares``,
    made at construction at ADAGRAD_INITIAL_ACC as optax's init makes it."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: float) -> None:
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(
                    p, ADAGRAD_INITIAL_ACC,
                    memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdagrad takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    adagrad_update_(p, p.grad,
                                    self.state[p]["sum_of_squares"],
                                    group["lr"])


def make_dense_optimizer(cfg: TrainerConfig,
                         params: Iterable[torch.nn.Parameter]
                         ) -> torch.optim.Optimizer:
    """The dense optimizer ``cfg.dense_optimizer`` over ``params`` at
    ``cfg.dense_lr`` (the parameters already on their device)."""
    name = cfg.dense_optimizer
    if name == "adam":
        return torch.optim.Adam(params, lr=cfg.dense_lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=cfg.dense_lr)
    return OptaxAdagrad(params, lr=cfg.dense_lr)


def check_opt_state(name: str, state: Mapping) -> None:
    """Raise ValueError unless ``state`` holds the fields of the dense
    optimizer ``name``'s state (STATE_FIELDS): a state written under
    another dense_optimizer does not load."""
    got = tuple(sorted(state))
    if got != STATE_FIELDS[name]:
        raise ValueError(
            "dense optimizer state with fields %s does not load into the "
            "%s optimizer (fields %s): it was written under another "
            "dense_optimizer" % (list(got), name, list(STATE_FIELDS[name])))


def opt_state_to_numpy(name: str, model: torch.nn.Module,
                       opt: torch.optim.Optimizer) -> Dict[str, object]:
    """The state of the dense optimizer ``name`` under optax's names, as
    numpy (STATE_FIELDS)."""
    if name == "adam":
        return adam_state_to_numpy(model, opt)
    if name == "adagrad":
        return adagrad_state_to_numpy(model, opt)
    return {}


def opt_state_from_numpy(name: str, model: torch.nn.Module,
                         opt: torch.optim.Optimizer,
                         state: Mapping) -> None:
    """Restore ``opt_state_to_numpy``'s form, bit for bit. A state of
    another optimizer raises ValueError (check_opt_state)."""
    check_opt_state(name, state)
    if name == "adam":
        adam_state_from_numpy(model, opt, state)
    elif name == "adagrad":
        adagrad_state_from_numpy(model, opt, state)
