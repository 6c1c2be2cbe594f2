"""Optimizer and LR schedules (counterpart of the reference's
``trainers/optim.py``, which builds them with Optax).

Every schedule is a function of the optimizer's own update count, as an
Optax schedule is: cosine / linear (warmup then decay) / step /
exponential / one_cycle / constant, from ``training.scheduler``. The
optimizer is Adam with ``training.beta1/beta2`` and eps 1e-8 (Optax's
defaults), behind an optional ``clip_by_global_norm`` (``grad_clip``) and
an optional skip of non-finite updates with ``optax.apply_if_finite``'s
semantics (``skip_nonfinite_updates``), and the first moment optionally
stored in another dtype (``adam_mu_dtype``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models.base import DTYPES

Schedule = Callable[[int], float]


def _cosine_decay(init_value: float, decay_steps: int,
                  alpha: float) -> Schedule:
    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _one_cycle(transition_steps: int, peak_value: float, pct_start: float,
               div_factor: float, final_div_factor: float) -> Schedule:
    """optax.cosine_onecycle_schedule: cosine from peak/div up to peak over
    ``pct_start`` of the steps, then down to peak/(div·final_div)."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = [peak_value / div_factor, peak_value,
              peak_value / (div_factor * final_div_factor)]

    def schedule(count):
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (
                    math.cos(math.pi * pct) + 1)
        return values[-1] if count >= bounds[-1] else 0.0
    return schedule


def make_lr_schedule(training_cfg: Dict[str, Any], steps_per_epoch: int,
                     num_epochs: int) -> Schedule:
    """The schedule named by ``training.scheduler.type``; epoch-based ones
    are converted to steps with ``steps_per_epoch``."""
    base_lr = float(training_cfg.get("learning_rate", 1e-4))
    sched_cfg = training_cfg.get("scheduler", {}) or {}
    stype = sched_cfg.get("type", "constant")
    total_steps = max(steps_per_epoch * num_epochs, 1)
    min_lr = float(sched_cfg.get("min_lr", 0.0))
    if stype == "cosine":
        return _cosine_decay(base_lr, total_steps, min_lr / base_lr)
    if stype == "linear":
        warmup = int(sched_cfg.get("warmup_steps", 0))
        up = _linear(0.0, base_lr, max(warmup, 1))
        down = _linear(base_lr, min_lr, max(total_steps - warmup, 1))
        return lambda step: up(step) if step < warmup else down(step - warmup)
    if stype == "step":
        step_size = max(int(sched_cfg.get("step_size", 100))
                        * steps_per_epoch, 1)
        gamma = float(sched_cfg.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** (step // step_size)
    if stype == "exponential":
        gamma = float(sched_cfg.get("gamma", 0.95))
        return lambda step: base_lr * gamma ** (step
                                                / max(steps_per_epoch, 1))
    if stype == "one_cycle":
        return _one_cycle(total_steps, base_lr,
                          float(sched_cfg.get("pct_start", 0.3)),
                          float(sched_cfg.get("div_factor", 25.0)),
                          float(sched_cfg.get("final_div_factor", 1e4)))
    if stype == "constant":
        return lambda step: base_lr
    raise ValueError(f"Unknown scheduler type: {stype}")


class Adam:
    """Adam over a list of parameters, with Optax's update rule
    ``p −= lr(count)·m̂/(√v̂ + eps)`` and its state: ``count`` (updates
    applied), ``mu`` (in ``mu_dtype``) and ``nu`` (f32), one per parameter.

    ``grad_clip``: scale the gradients by max_norm/‖g‖ when ‖g‖ ≥ max_norm
    (``optax.clip_by_global_norm``). ``max_consecutive_errors`` > 0: a step
    whose gradients are not all finite changes neither the parameters nor
    the moments nor ``count``, until more than that many such steps come
    in a row; then the update is applied (``optax.apply_if_finite``).
    ``mu_dtype``: the stored first moment's dtype. In optax's order, the
    update uses the f32 moment (1−b1)·g + b1·μ (b1 rounded to
    ``mu_dtype``), and only then is μ rounded to ``mu_dtype`` for
    storage.
    """

    def __init__(self, params: List[torch.Tensor], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 0.0, max_consecutive_errors: int = 0,
                 mu_dtype: torch.dtype = torch.float32):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = float(grad_clip or 0.0)
        self.max_consecutive_errors = int(max_consecutive_errors)
        self.count = 0
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.mu_dtype = mu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             grad_norm: torch.Tensor) -> bool:
        """Apply one update from ``grads`` (clipped in place) given their
        global norm; returns False when the update was skipped."""
        if self.max_consecutive_errors:
            if bool(torch.isfinite(grad_norm)):
                self.notfinite_count = 0
            else:
                self.notfinite_count += 1
                self.total_notfinite += 1
                if self.notfinite_count <= self.max_consecutive_errors:
                    return False
        if self.grad_clip:
            keep = grad_norm < self.grad_clip
            one = torch.ones_like(grad_norm)
            torch._foreach_div_(grads, torch.where(keep, one, grad_norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, one * self.grad_clip))
        lr = self.schedule(self.count)
        self.count += 1
        if self.mu_dtype == torch.float32:
            mu = self.mu
            torch._foreach_mul_(mu, self.b1)
        else:
            # b1 rounded to μ's dtype, as JAX's weakly typed b1 is; the
            # product stays f32, as the compiled optax update keeps it.
            b1 = float(torch.tensor(self.b1, dtype=self.mu_dtype))
            mu = torch._foreach_mul([m.float() for m in self.mu], b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, math.sqrt(bc2))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, mu, denom, value=-lr / bc1)
        if mu is not self.mu:
            torch._foreach_copy_(self.mu, mu)
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "mu": [m.detach().cpu() for m in self.mu],
                "nu": [n.detach().cpu() for n in self.nu]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state has {len(state['mu'])} "
                             f"moments for {len(self.mu)} parameters")
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                dst.copy_(src)


def make_optimizer(params: List[torch.Tensor], training_cfg: Dict[str, Any],
                   steps_per_epoch: int, num_epochs: int
                   ) -> Tuple[Adam, Schedule]:
    """Adam (+clip, +non-finite skip) with the configured LR schedule;
    the schedule is also returned, for logging the LR."""
    schedule = make_lr_schedule(training_cfg, steps_per_epoch, num_epochs)
    skip = training_cfg.get("skip_nonfinite_updates", 0)
    max_errors = (100 if isinstance(skip, bool) else int(skip)) if skip else 0
    opt = Adam(params, schedule,
               b1=float(training_cfg.get("beta1", 0.9)),
               b2=float(training_cfg.get("beta2", 0.999)),
               grad_clip=float(training_cfg.get("grad_clip") or 0.0),
               max_consecutive_errors=max_errors,
               mu_dtype=dtype_from_config(training_cfg, "adam_mu_dtype"))
    return opt, schedule


def dtype_from_config(training_cfg: Dict[str, Any], key: str) -> torch.dtype:
    """The storage dtype ``training.<key>`` names (float32 when unset)."""
    name = str(training_cfg.get(key) or "float32")
    if name not in DTYPES:
        raise ValueError(f"training.{key} must be one of {sorted(DTYPES)}, "
                         f"got {name!r}")
    return DTYPES[name]
