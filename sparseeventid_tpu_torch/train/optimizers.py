"""Optimizer factory (JAX counterpart: ``train/optimizers.py``, which builds
all eight kinds through optax 0.2.6).  Every kind takes base lr 1.0 scaled
by the per-step schedule through a ``LambdaLR``, stepped after each
optimizer step, so a group's ``lr`` is the schedule at the number of
updates made so far: optax's ``scale_by_learning_rate(schedule)``.

``adam`` is ``torch.optim.AdamW`` with betas (0.8, 0.9), eps 1e-6 and
decoupled weight decay, which is ``optax.adamw`` step for step:
p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p).

PyTorch's own RMSprop, Adagrad and Adadelta compute other formulas than
optax's (other defaults, eps inside or outside the root, another initial
accumulator), and it has no LARS, LAMB or NovoGrad; so ``OptaxRule`` writes
the other seven update rules out, with optax's defaults and the weight
decay only where the JAX package passes it (lars, lamb, novograd; their
optax masks select every parameter):

  sgd       u = g
  rmsprop   nu = 0.9 nu + 0.1 g^2 (nu0 = 0);  u = g / sqrt(nu + 1e-8)
  adagrad   s = s + g^2 (s0 = 0.1);  u = g / sqrt(s + 1e-7) where s > 0
  adadelta  eg = 0.9 eg + 0.1 g^2;  u = sqrt(ex + 1e-6) / sqrt(eg + 1e-6) g;
            ex = 0.9 ex + 0.1 u^2
  lars      u = g + wd p;  u *= 0.001 |p| / |u| (1 where a norm is 0);
            t = -lr u + 0.9 t;  p += t   (the rate before the momentum)
  lamb      Adam's (0.9, 0.999, eps 1e-6) bias-corrected direction + wd p,
            times |p| / |u| (1 where a norm is 0)
  novograd  nu = |g|^2 at the first step, then 0.25 nu + 0.75 |g|^2;
            m = g / (sqrt(nu) + 1e-6) + wd p, then 0.9 m + that;  u = m

and p <- p - lr_t * u (LARS adds its trace instead).  Norms are per tensor
(a torch parameter is one optax leaf: the port keeps the flax names, and a
transposed ``Dense`` kernel has the same norms).

A transfer run's frozen encoder (the JAX ``optax.multi_transform`` with
``set_to_zero``) is the caller's: ``trainer.build_training`` passes only the
parameters that need a gradient, and every rule here is per tensor, so the
frozen ones change nothing.  ``optax.MultiSteps`` (gradient accumulation)
is the train steps' (the mean of k micro-steps' gradients, the schedule
moving on updates only).  ``flatten_update`` (``optax.flatten``) changes no
number of an elementwise rule, so it is not needed here and is ignored.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from ..config.schema import OptimizerConfig, OptimizerKind

# optax 0.2.6's defaults, as the JAX factory calls each kind
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6
LARS_TRUST, LARS_MOMENTUM = 0.001, 0.9
LAMB_B1, LAMB_B2, LAMB_EPS = 0.9, 0.999, 1e-6
NOVOGRAD_B1, NOVOGRAD_B2, NOVOGRAD_EPS = 0.9, 0.25, 1e-6


def _trust_ratio(u: torch.Tensor, p: torch.Tensor,
                 coefficient: float = 1.0) -> torch.Tensor:
    """optax ``scale_by_trust_ratio``: coefficient * |p| / |u|, 1 where
    either norm is 0."""
    p_norm = torch.linalg.vector_norm(p)
    u_norm = torch.linalg.vector_norm(u)
    ratio = coefficient * p_norm / u_norm
    return torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio),
                       ratio)


class OptaxRule(torch.optim.Optimizer):
    """One of optax's update rules (``kind``: sgd, rmsprop, adagrad,
    adadelta, lars, lamb, novograd), base lr 1.0; the state lives in
    ``self.state`` as tensors, so ``state_dict`` checkpoints it."""

    KINDS = ("sgd", "rmsprop", "adagrad", "adadelta", "lars", "lamb",
             "novograd")

    def __init__(self, params, kind: str, weight_decay: float = 0.0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown update rule {kind!r}")
        super().__init__(params, dict(lr=1.0, weight_decay=weight_decay))
        self.kind = kind

    def _init_state(self, p: torch.Tensor):
        z = lambda: torch.zeros_like(p, memory_format=torch.preserve_format)
        if self.kind == "rmsprop":
            return {"nu": z()}
        if self.kind == "adagrad":
            return {"sum_sq": torch.full_like(p, ADAGRAD_INIT)}
        if self.kind == "adadelta":
            return {"e_g": z(), "e_x": z()}
        if self.kind == "lars":
            return {"trace": z()}
        if self.kind == "lamb":
            return {"step": torch.zeros((), dtype=torch.int64), "mu": z(),
                    "nu": z()}
        if self.kind == "novograd":
            return {"step": torch.zeros((), dtype=torch.int64), "mu": z(),
                    "nu": torch.zeros((), dtype=p.dtype, device=p.device)}
        return {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                self._update(p, p.grad, state, lr, wd)
        return loss

    def _update(self, p, g, state, lr: float, wd: float) -> None:
        kind = self.kind
        if kind == "sgd":
            p.add_(g, alpha=-lr)
        elif kind == "rmsprop":
            nu = state["nu"]
            nu.mul_(RMSPROP_DECAY).add_(g * g, alpha=1 - RMSPROP_DECAY)
            p.add_(g * torch.rsqrt(nu + RMSPROP_EPS), alpha=-lr)
        elif kind == "adagrad":
            s = state["sum_sq"]
            s.add_(g * g)
            scale = torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS),
                                torch.zeros_like(s))
            p.add_(scale * g, alpha=-lr)
        elif kind == "adadelta":
            e_g, e_x = state["e_g"], state["e_x"]
            e_g.mul_(ADADELTA_RHO).add_(g * g, alpha=1 - ADADELTA_RHO)
            u = torch.sqrt(e_x + ADADELTA_EPS) / torch.sqrt(e_g + ADADELTA_EPS) * g
            e_x.mul_(ADADELTA_RHO).add_(u * u, alpha=1 - ADADELTA_RHO)
            p.add_(u, alpha=-lr)
        elif kind == "lars":
            u = g + wd * p
            u = u * _trust_ratio(u, p, LARS_TRUST)
            trace = state["trace"]
            trace.mul_(LARS_MOMENTUM).add_(u, alpha=-lr)
            p.add_(trace)
        elif kind == "lamb":
            state["step"] += 1
            t = int(state["step"])
            mu, nu = state["mu"], state["nu"]
            mu.mul_(LAMB_B1).add_(g, alpha=1 - LAMB_B1)
            nu.mul_(LAMB_B2).add_(g * g, alpha=1 - LAMB_B2)
            mu_hat = mu / (1 - LAMB_B1**t)
            nu_hat = nu / (1 - LAMB_B2**t)
            u = mu_hat / (torch.sqrt(nu_hat) + LAMB_EPS) + wd * p
            p.add_(u * _trust_ratio(u, p), alpha=-lr)
        elif kind == "novograd":
            state["step"] += 1
            sq = torch.linalg.vector_norm(g) ** 2
            nu, mu = state["nu"], state["mu"]
            if int(state["step"]) == 1:
                nu.copy_(sq)
            else:
                nu.mul_(NOVOGRAD_B2).add_(sq * (1 - NOVOGRAD_B2))
            direction = g / (torch.sqrt(nu) + NOVOGRAD_EPS) + wd * p
            if int(state["step"]) == 1:
                mu.copy_(direction)
            else:
                mu.mul_(NOVOGRAD_B1).add_(direction)
            p.add_(mu, alpha=-lr)


def build_optimizer(
    cfg: OptimizerConfig,
    lr_schedule: Callable[[int], float],
    params: Iterable[torch.nn.Parameter],
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    kind = cfg.name
    if kind == OptimizerKind.adam:
        optimizer = torch.optim.AdamW(
            params, lr=1.0, betas=(0.8, 0.9), eps=1e-6,
            weight_decay=cfg.weight_decay,
        )
    elif kind in (OptimizerKind.lars, OptimizerKind.lamb,
                  OptimizerKind.novograd):
        optimizer = OptaxRule(params, kind.name, cfg.weight_decay)
    elif kind in (OptimizerKind.rmsprop, OptimizerKind.sgd,
                  OptimizerKind.adagrad, OptimizerKind.adadelta):
        optimizer = OptaxRule(params, kind.name)
    else:
        raise ValueError(f"unsupported optimizer {kind}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_schedule)
    return optimizer, scheduler
