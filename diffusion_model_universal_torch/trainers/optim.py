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
from typing import Any, Callable, Dict, List, Optional, Tuple

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

    Nothing in an update reads the host: the per-update scalars, √(1−b2ᶜ)
    and −lr(c−1)/(1−b1ᶜ) for count c after the update, come from a table
    the host fills (:meth:`scalar_table`), and the non-finite skip is a
    select on the device, with ``count``, ``notfinite_count`` and
    ``total_notfinite`` kept there (reading one waits for the card). So
    one update, or K of them captured in a CUDA graph, runs without a
    sync. Without the skip the host knows the count; with it the host
    reads it once per table.

    ``sharding`` (``parallel/mesh.py::Sharding``, under
    ``model_parallel``): ``params`` are this rank's shards of the sharded
    leaves (whole for the rest), so are μ and ν; :meth:`state_dict` and
    :meth:`load_state_dict` keep the whole tensors of one process.
    """

    def __init__(self, params: List[torch.Tensor], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 0.0, max_consecutive_errors: int = 0,
                 mu_dtype: torch.dtype = torch.float32, sharding=None):
        self.params = list(params)
        self.sharding = sharding
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = float(grad_clip or 0.0)
        self.max_consecutive_errors = int(max_consecutive_errors)
        self.device = (self.params[0].device if self.params
                       else torch.device("cpu"))
        #: count, notfinite_count, total_notfinite.
        self.counters = torch.zeros(3, dtype=torch.int64, device=self.device)
        #: Updates issued; equal to count without the skip.
        self._issued = 0
        self.mu_dtype = mu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    @property
    def count(self) -> int:
        return int(self.counters[0])

    @property
    def notfinite_count(self) -> int:
        return int(self.counters[1])

    @property
    def total_notfinite(self) -> int:
        return int(self.counters[2])

    def scalar_table(self, n: int) -> torch.Tensor:
        """[n, 2] f32 on the host: row j holds √(1−b2ᶜ) and −lr(c−1)/(1−b1ᶜ)
        for c = count + 1 + j, the scalars of the (j+1)-th update from now
        (row j of an update that finds ``count`` advanced by j since the
        table was made). Reads the count from the card under the skip."""
        c0 = (int(self.counters[0]) if self.max_consecutive_errors
              else self._issued)
        rows = []
        for c in range(c0 + 1, c0 + 1 + n):
            rows.append((math.sqrt(1 - self.b2 ** c),
                         -self.schedule(c - 1) / (1 - self.b1 ** c)))
        return torch.tensor(rows, dtype=torch.float32)

    def advance(self, n: int) -> None:
        """Account on the host for ``n`` updates applied from a table."""
        self._issued += n

    def row(self, table: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
        """The row of ``table`` (made when the count was ``start``, a
        device scalar) for the next update, chosen on the device."""
        return table.index_select(0, (self.counters[0] - start).view(1))[0]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], grad_norm: torch.Tensor,
             scalars: Optional[torch.Tensor] = None):
        """Apply one update from ``grads`` (clipped in place) given their
        global norm. ``scalars``: this update's row of a
        :meth:`scalar_table` on the device (default: made here from the
        host's count). Returns True, or under the skip a device bool that
        is False when the update was skipped."""
        if scalars is None:
            scalars = to_device(self.scalar_table(1), self.device)[0]
            self._issued += 1
        sqrt_bc2, step_size = scalars[0], scalars[1]
        apply = None
        if self.max_consecutive_errors:
            # optax.apply_if_finite as a select: a skipped update sees zero
            # gradients (so nothing below turns non-finite) and keeps the
            # old parameters and moments.
            finite = torch.isfinite(grad_norm)
            nf = torch.where(finite, torch.zeros_like(self.counters[1]),
                             self.counters[1] + 1)
            apply = finite | (nf > self.max_consecutive_errors)
            self.counters[1:].copy_(torch.stack(
                [nf, self.counters[2] + (~finite).long()]))
            for g in grads:
                g.masked_fill_(~apply, 0.0)
            grad_norm = torch.where(apply, grad_norm,
                                    torch.zeros_like(grad_norm))
        if self.grad_clip:
            keep = grad_norm < self.grad_clip
            one = torch.ones_like(grad_norm)
            torch._foreach_div_(grads, torch.where(keep, one, grad_norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, one * self.grad_clip))
        if self.mu_dtype == torch.float32 and apply is None:
            mu = self.mu
            torch._foreach_mul_(mu, self.b1)
        elif self.mu_dtype == torch.float32:
            mu = torch._foreach_mul(self.mu, self.b1)
        else:
            # b1 rounded to μ's dtype, as JAX's weakly typed b1 is; the
            # product stays f32, as the compiled optax update keeps it.
            b1 = float(torch.tensor(self.b1, dtype=self.mu_dtype))
            mu = torch._foreach_mul([m.float() for m in self.mu], b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        if apply is None:
            nu = self.nu
            torch._foreach_mul_(nu, self.b2)
        else:
            nu = torch._foreach_mul(self.nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_div_(denom, sqrt_bc2)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, denom)
        del denom
        torch._foreach_mul_(update, step_size)
        if apply is None:
            torch._foreach_add_(self.params, update)
            self.counters[0] += 1
        else:
            torch._foreach_add_(update, self.params)
            for dst, src in zip(self.params + self.nu, update + nu):
                torch.where(apply, src, dst, out=dst)
            if mu is not self.mu:
                mu = [torch.where(apply, m, old.float()) for m, old in
                      zip(mu, self.mu)]
            self.counters[0] += apply.long()
        if mu is not self.mu:
            torch._foreach_copy_(self.mu, mu)
        return True if apply is None else apply

    def state_dict(self, gather: bool = True) -> Dict[str, Any]:
        """The state with whole moments (gathered from every shard under
        ``sharding``: every rank of the group must call this), or with
        this rank's own when not ``gather``."""
        mu, nu = self.mu, self.nu
        if self.sharding is not None and gather:
            mu, nu = self.sharding.whole(mu), self.sharding.whole(nu)
        count, notfinite, total = self.counters.tolist()
        return {"count": count, "notfinite_count": notfinite,
                "total_notfinite": total,
                "mu": [m.detach().cpu().clone() for m in mu],
                "nu": [n.detach().cpu().clone() for n in nu]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state has {len(state['mu'])} "
                             f"moments for {len(self.mu)} parameters")
        self.counters.copy_(torch.tensor(
            [int(state["count"]), int(state["notfinite_count"]),
             int(state["total_notfinite"])]))
        self._issued = int(state["count"])
        mu, nu = state["mu"], state["nu"]
        if self.sharding is not None:   # this rank's shards of the whole
            mu, nu = self.sharding.shards(mu), self.sharding.shards(nu)
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
                dst.copy_(src)


def to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host table on ``device`` without waiting for the card: on
    CUDA through pinned memory and an asynchronous copy."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def make_optimizer(params: List[torch.Tensor], training_cfg: Dict[str, Any],
                   steps_per_epoch: int, num_epochs: int, sharding=None
                   ) -> Tuple[Adam, Schedule]:
    """Adam (+clip, +non-finite skip) with the configured LR schedule
    (over this rank's shards with ``sharding``); the schedule is also
    returned, for logging the LR."""
    schedule = make_lr_schedule(training_cfg, steps_per_epoch, num_epochs)
    skip = training_cfg.get("skip_nonfinite_updates", 0)
    max_errors = (100 if isinstance(skip, bool) else int(skip)) if skip else 0
    opt = Adam(params, schedule,
               b1=float(training_cfg.get("beta1", 0.9)),
               b2=float(training_cfg.get("beta2", 0.999)),
               grad_clip=float(training_cfg.get("grad_clip") or 0.0),
               max_consecutive_errors=max_errors,
               mu_dtype=dtype_from_config(training_cfg, "adam_mu_dtype"),
               sharding=sharding)
    return opt, schedule


def dtype_from_config(training_cfg: Dict[str, Any], key: str) -> torch.dtype:
    """The storage dtype ``training.<key>`` names (float32 when unset)."""
    name = str(training_cfg.get(key) or "float32")
    if name not in DTYPES:
        raise ValueError(f"training.{key} must be one of {sorted(DTYPES)}, "
                         f"got {name!r}")
    return DTYPES[name]
