"""Functional optimizers over trees of tensors: the port's copy of
`repro/optim/optimizers.py` (no `torch.optim`).

An `Optimizer` is a pair of functions, as in the reference:
  init(params)                       -> opt_state (a tree)
  update(grads, state, params, step) -> (updates, new_state)
and `apply_`, which adds each leaf's update into its parameter as soon as
it is computed (what a training step on the card calls: the whole updates
tree would be one more copy of the parameters).  Each optimizer's formula
is the reference's line for line, in float32: AdamW's weight decay inside
the update, its bias corrections at ``step + 1`` (b2 0.95 and weight decay
0.1 by default), Adafactor's factored second moment and update clipping,
SGD with momentum.  ``step`` is an int or a 0-dim integer tensor; the
schedules give 0-dim float32 tensors, computed as the reference computes
its jnp scalars.

Unlike the reference's, ``update`` writes the new moments into the state's
own tensors (the returned state holds them): one copy of the moments lives
on the card, as with a donated JAX state.  The updates it returns are new
tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.utils import tree_leaves, tree_map

f32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares, fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(f32)))
                          for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled by min(1, max_norm / max(norm, 1e-9)), the norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


def clip_by_global_norm_(tree, max_norm: float) -> torch.Tensor:
    """`clip_by_global_norm` in place (the same products, written into the
    leaves); returns the norm."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    for x in tree_leaves(tree):
        x.mul_(scale)
    return norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warm-up to base_lr over ``warmup`` steps, then a cosine decay
    to min_ratio * base_lr at ``total``: a 0-dim float32 tensor a step."""
    def lr(step):
        step = torch.as_tensor(step).to(f32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def _step_tensor(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``prepare(step)`` the step's scalars;
    ``leaf(g, s, p, scalars) -> (update, new s)`` one parameter's step,
    where s is that parameter's slice of the state (`split` / `join` convert
    between the state tree and the per-leaf slices)."""
    init: Callable[[Any], Any]
    prepare: Callable[[Any], Any]
    leaf: Callable[..., Any]
    split: Callable[[Any, Any], Any]
    join: Callable[[Any, Any], Any]

    def update(self, grads, state, params, step):
        """(updates, new_state) over the whole tree, as the reference's."""
        scalars = self.prepare(step)
        out = tree_map(lambda p, g, s: self.leaf(g, s, p, scalars), params,
                       grads, self.split(state, params))
        return (tree_map(lambda p, o: o[0], params, out),
                self.join(tree_map(lambda p, o: o[1], params, out), params))

    @torch.no_grad()
    def apply_(self, grads, state, params, step):
        """Each parameter += its update (``(p + u)`` in p's dtype, as the
        reference's train step adds them), leaf by leaf; returns the new
        state.  grads, params: trees of one structure."""
        scalars = self.prepare(step)

        def one(p, g, s):
            u, s2 = self.leaf(g, s, p, scalars)
            p.copy_((p + u).to(p.dtype))
            return s2

        return self.join(tree_map(one, params, grads,
                                  self.split(state, params)), params)


def _by_name(*names):
    """split / join of a state {name: tree like params} (adamw, sgdm,
    sparse_adamw) into per-leaf dicts {name: tensor}."""
    def split(state, params):
        return tree_map(lambda p, *xs: dict(zip(names, xs)), params,
                        *(state[n] for n in names))

    def join(slices, params):
        return {n: tree_map(lambda p, s: s[n], params, slices) for n in names}

    return split, join


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=f32)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def prepare(step):
        step1 = _step_tensor(step) + 1
        t = step1.to(f32)
        return dict(lr=lr_fn(step),
                    bc1=1 - torch.pow(torch.tensor(b1, dtype=f32), t),
                    bc2=1 - torch.pow(torch.tensor(b2, dtype=f32), t))

    def leaf(g, s, p, c):
        g = g.to(f32)
        m2 = b1 * s["m"] + (1 - b1) * g
        v2 = b2 * s["v"] + (1 - b2) * torch.square(g)
        mh, vh = m2 / c["bc1"], v2 / c["bc2"]
        u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(f32)
        s["m"].copy_(m2)
        s["v"].copy_(v2)
        return (-c["lr"] * u).to(p.dtype), s

    return Optimizer(init, prepare, leaf, *_by_name("m", "v"))


def adafactor(lr_fn, decay=0.8, eps=1e-30, weight_decay=0.0,
              min_dim_factored=128) -> Optimizer:
    """Factored second moment (Shazeer & Stern).  Params with >= 2 dims whose
    trailing two dims are both >= min_dim_factored get factored row/col
    stats; everything else a full second moment."""

    def _factored(p):
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def one(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=f32)}

        return tree_map(one, params)

    def prepare(step):
        t = _step_tensor(step).to(f32) + 1
        return dict(lr=lr_fn(step), beta=1.0 - t ** (-decay))

    def leaf(g, s, p, c):
        beta = c["beta"]
        g = g.to(f32)
        g2 = torch.square(g) + eps
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                vr.mean(-1)[..., None, None], min=eps)
            u = g * torch.rsqrt(denom + eps)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(v + eps)
            s["v"].copy_(v)
        # update clipping (RMS <= 1) per Adafactor
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms, min=1.0)
        if weight_decay:
            u = u + weight_decay * p.to(f32)
        return (-c["lr"] * u).to(p.dtype), s

    def split(state, params):
        return state

    def join(slices, params):
        return slices

    return Optimizer(init, prepare, leaf, split, join)


def sgdm(lr_fn, momentum=0.9, weight_decay=0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)}

    def prepare(step):
        return dict(lr=lr_fn(step))

    def leaf(g, s, p, c):
        g = g.to(f32) + weight_decay * p.to(f32)
        m2 = momentum * s["m"] + g
        s["m"].copy_(m2)
        return (-c["lr"] * m2).to(p.dtype), s

    return Optimizer(init, prepare, leaf, *_by_name("m"))


def _optimizer_factories():
    """Name -> factory (a function, so sparse_optim can import this module
    without a cycle)."""
    from repro_torch.optim.sparse_optim import sparse_adamw

    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm,
            "sparse_adamw": sparse_adamw}


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    factories = _optimizer_factories()
    if name not in factories:
        raise ValueError(
            f"unknown optimizer {name!r}: valid names are "
            f"{sorted(factories)}")
    return factories[name](lr_fn, **kw)
