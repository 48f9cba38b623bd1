"""Optimizers over scene-parameter dicts (mitsuba_tpu/utils/optimizers.py;
reference src/python/python/ad/optimizers.py).

Functional, as in the JAX package: an optimizer holds hyperparameters,
and its state is an explicit dict threaded through
``step(params, grads, state) -> (params, state)``, so a state exported
from the JAX package as numpy carries across.  ``Adam`` writes the JAX
package's update, ``lr * sqrt(1 - beta_2^t) / (1 - beta_1^t) * m /
(sqrt(v) + epsilon)``, which ``torch.optim.Adam`` does not (it adds
epsilon after the bias correction).
"""
from __future__ import annotations

import torch


def _tensor(x, like=None):
    """``x`` as a tensor (an array is copied), on ``like``'s device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t if like is None else t.to(like.device)


class Optimizer:
    """Base: per-parameter learning-rate overrides via
    ``set_learning_rate``."""

    def __init__(self, lr: float):
        self.lr = lr
        self.lr_per_param: dict[str, float] = {}

    def set_learning_rate(self, overrides: dict[str, float] | float):
        if isinstance(overrides, dict):
            self.lr_per_param.update(overrides)
        else:
            self.lr = float(overrides)

    def _lr(self, key):
        return self.lr_per_param.get(key, self.lr)

    def init(self, params: dict):
        raise NotImplementedError

    def step(self, params: dict, grads: dict, state: dict):
        raise NotImplementedError


class SGD(Optimizer):
    """SGD with optional momentum (optimizers.py:112); ``mask_updates``
    freezes the elements whose gradient is exactly zero this step."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 mask_updates: bool = False):
        super().__init__(lr)
        self.momentum = momentum
        self.mask_updates = mask_updates

    def init(self, params):
        if self.momentum == 0.0:
            return {}
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads, state):
        new_p, new_s = {}, {}
        with torch.no_grad():
            for k, p in params.items():
                g = _tensor(grads[k], p)
                lr = self._lr(k)
                if self.momentum != 0.0:
                    s = _tensor(state[k], p)
                    v = self.momentum * s + g
                    if self.mask_updates:
                        v = torch.where(g != 0.0, v, s)
                    new_s[k] = v
                    upd = lr * v
                else:
                    upd = lr * g
                if self.mask_updates:
                    upd = torch.where(g != 0.0, upd, 0.0)
                new_p[k] = p - upd
        return new_p, new_s


class Adam(Optimizer):
    """Adam with bias correction; ``mask_updates`` freezes the elements
    whose gradient is exactly zero this step; ``uniform`` divides by the
    largest second moment across elements (UniformAdam, optimizers.py:204
    variants)."""

    def __init__(self, lr: float, beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-8, mask_updates: bool = False,
                 uniform: bool = False):
        super().__init__(lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.mask_updates = mask_updates
        self.uniform = uniform

    def init(self, params):
        return {"t": torch.zeros((), dtype=torch.int32),
                "m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()}}

    def step(self, params, grads, state):
        t = _tensor(state["t"]).to(torch.int32) + 1
        tf = t.to(torch.float32)
        # float32, as the JAX package computes it
        lr_scale = (torch.sqrt(1.0 - torch.pow(self.beta_2, tf))
                    / (1.0 - torch.pow(self.beta_1, tf)))
        new_p, new_m, new_v = {}, {}, {}
        with torch.no_grad():
            for k, p in params.items():
                g = _tensor(grads[k], p)
                m0, v0 = _tensor(state["m"][k], p), _tensor(state["v"][k], p)
                m = self.beta_1 * m0 + (1.0 - self.beta_1) * g
                v = self.beta_2 * v0 + (1.0 - self.beta_2) * g * g
                if self.mask_updates:
                    nz = g != 0.0
                    m = torch.where(nz, m, m0)
                    v = torch.where(nz, v, v0)
                denom = torch.sqrt(v.max()) if self.uniform else torch.sqrt(v)
                upd = (self._lr(k) * lr_scale.to(p.device)) * m \
                    / (denom + self.epsilon)
                if self.mask_updates:
                    upd = torch.where(g != 0.0, upd, 0.0)
                new_p[k] = p - upd
                new_m[k] = m
                new_v[k] = v
        return new_p, {"t": t, "m": new_m, "v": new_v}
