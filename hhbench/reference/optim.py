"""AdamW (decoupled weight decay, Loshchilov & Hutter): each step
p <- p * (1 - lr * wd), then the bias-corrected Adam update
lr * m_hat / (sqrt(v_hat) + eps)."""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params: dict, decay: dict, lr, b1, b2, eps=1e-8):
        """``params``: name -> leaf tensor; ``decay``: name -> weight decay."""
        self.params, self.decay = params, decay
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.decay[k])
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))
