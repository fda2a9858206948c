"""AdamW with decoupled weight decay (counterpart of
``repro.optim.adamw``): the reference's math, moments in float32.

The state is ``{"mu", "nu", "step"}``: ``mu`` and ``nu`` map each
parameter's name (``named_parameters()`` of a module, or the keys of a
flat mapping of tensors) to a float32 tensor of its shape, and ``step``
is an int32 scalar tensor.  Unlike the reference's pure function,
:func:`adamw_update` writes the new parameters and moments into the
tensors it is given.  Everything that can fail before a write (the
global norm, the clip, the bias corrections and the scratch the writes
use) is computed or allocated first, so a step that raises there leaves
parameters and state as they were, and a retry starts from the same
point.  The writes allocate nothing; an error among them (a fault of the
card) raises :class:`PartialUpdateError`, which is not a
``RuntimeError``, so ``run_step_with_retry`` does not run a half-updated
step again.  ``torch.optim.AdamW`` is a different function: it clips
separately and decays before the Adam step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "named_leaves",
           "global_norm", "PartialUpdateError"]


class PartialUpdateError(Exception):
    """:func:`adamw_update` failed after its first write: parameters and
    moments are part old, part new, and the step must not be run again.
    The error that stopped the writes is its ``__cause__``."""


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def named_leaves(params: Any) -> Dict[str, torch.Tensor]:
    """The parameters by name: a module's ``named_parameters()``, or a
    flat mapping of names to tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, Mapping):
        return dict(params)
    raise TypeError(f"params must be an nn.Module or a mapping of tensors, "
                    f"got {type(params).__name__}")


def adamw_init(params: Any) -> dict:
    """Zero float32 moments for every parameter and ``step`` 0 (int32),
    on the parameters' devices."""
    leaves = named_leaves(params)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in leaves.items()}

    device = next(iter(leaves.values())).device if leaves else "cpu"
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of g**2 over every leaf + 1e-16)`` in float32, the
    leaves summed in order.  A float32 leaf is squared by a dot product
    with itself, so a 2 GB table takes no temporary."""
    total = None
    for g in grads.values():
        flat = g.reshape(-1)
        flat = flat if flat.dtype == torch.float32 else flat.float()
        sq = torch.dot(flat, flat)
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("global_norm: no gradients")
    return torch.sqrt(total + 1e-16)


def _scratch(leaves: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]):
    """Two flat float32 buffers on the parameters' device, one the size
    of the largest leaf (the update) and one the size of the largest
    leaf whose gradient is not float32 (its float32 copy)."""
    device = next(iter(leaves.values())).device
    for n, p in leaves.items():
        if p.device != device or grads[n].device != device:
            raise ValueError(f"adamw_update: {n} is not on {device}")
    n_upd = max(p.numel() for p in leaves.values())
    n_g32 = max((p.numel() for n, p in leaves.items()
                 if grads[n].dtype != torch.float32), default=0)
    return (torch.empty(n_upd, dtype=torch.float32, device=device),
            torch.empty(n_g32, dtype=torch.float32, device=device))


def _update_leaf(p, g, m, v, scale, bc1, bc2, cfg, upd_buf, g32_buf):
    """One leaf's AdamW write, in place and into the scratch only."""
    if g.dtype == torch.float32:
        g = g.mul_(scale)
    else:
        g = g32_buf[:g.numel()].view(g.shape).copy_(g).mul_(scale)
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).add_(g.mul_(g), alpha=1 - cfg.b2)
    denom = torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps)
    upd = torch.div(m, bc1, out=upd_buf[:m.numel()].view(m.shape))
    upd.div_(denom)
    if p.dtype == torch.float32:
        upd.add_(p, alpha=cfg.weight_decay)
        p.sub_(upd, alpha=cfg.lr)
    else:
        p32 = g.copy_(p)                    # the denominator is used up
        upd.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(upd, alpha=cfg.lr))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict, params: Any,
                 cfg: AdamWConfig) -> Tuple[Any, dict, torch.Tensor]:
    """One AdamW step (``adamw.py:33-60``): clip the gradients by their
    global norm, then for each leaf ``m = b1 m + (1 - b1) g``, ``v = b2 v
    + (1 - b2) g^2`` and ``p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)``
    in float32, cast back to the parameter's type.

    ``grads`` maps every parameter name to its gradient and is used up:
    a float32 gradient is scaled in place and then holds the
    denominator, or the parameter's float32 copy where the parameter is
    not float32.  Raises :class:`PartialUpdateError` if a write fails.
    Writes the parameters, ``state["mu"]``,
    ``state["nu"]`` and ``state["step"]`` in place; returns ``(params,
    state, gnorm)``."""
    leaves = named_leaves(params)
    if set(grads) != set(leaves):
        raise ValueError(f"adamw_update: gradients for {sorted(grads)}, "
                         f"parameters {sorted(leaves)}")
    # everything that can fail comes before the first write
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / gnorm, max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    mus, nus = state["mu"], state["nu"]
    for name, p in leaves.items():
        if mus[name].shape != p.shape or nus[name].shape != p.shape:
            raise ValueError(f"adamw_update: the moments of {name} do not "
                             f"have its shape {tuple(p.shape)}")
    upd_buf, g32_buf = _scratch(leaves, grads)
    written = 0
    try:
        for name, p in leaves.items():
            _update_leaf(p, grads[name], mus[name], nus[name], scale, bc1,
                         bc2, cfg, upd_buf, g32_buf)
            written += 1
        state["step"].copy_(step)
    except Exception as exc:
        raise PartialUpdateError(
            f"adamw_update failed at {name} after writing {written} of "
            f"{len(leaves)} leaves") from exc
    return params, state, gnorm
