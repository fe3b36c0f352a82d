"""AdamW with bf16 parameters and f32 moments (port of
``repro.train.optimizer``), over a parameter tree of nested dicts of
tensors.

The update is the reference's formula, step for step and in the same
dtypes: global-norm clipping in f32, moments in f32, bias correction, the
update ``mhat / (sqrt(vhat) + eps) + wd * p`` and one rounding to the
parameter's dtype.  ``torch.optim.AdamW`` decays the parameter before the
step and rounds elsewhere, so it is not used.  The step count stays on the
parameters' device (an int32 scalar), so an update makes no host sync.

``adamw_update`` is a pure function, as the reference's is: it returns new
parameters and moments and leaves its arguments as they are.  It takes
each leaf in chunks of ``CHUNK`` elements, clipping the gradient and
updating the moments and the parameter chunk by chunk into the new
leaves, so that its f32 temporaries are a few chunks at a time and no
clipped copy of the gradients is made: the layers' weights are stacked
into leaves of up to billions of elements, whose whole-leaf f32
temporaries would otherwise add several times 4 bytes for each of their
elements to a training step's peak.  Every operation is elementwise, so
the chunks give the bits of the whole-leaf formula.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "tree_map", "tree_leaves", "tree_unzip"]

CHUNK = 1 << 25     # elements of a leaf that one pass of the update takes


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts ``tree`` (and of ``rest``,
    which share its structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in the dicts' order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unzip(tree, n: int) -> tuple:
    """A tree whose leaves are n-tuples -> n trees."""
    return tuple(tree_map(lambda leaf, i=i: leaf[i], tree) for i in range(n))


@dataclasses.dataclass
class OptState:
    m: dict             # first moments, f32, the parameters' structure
    v: dict             # second moments, f32
    step: torch.Tensor  # int32 scalar on the parameters' device


def adamw_init(params: dict) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device))


def _clip_scale(grads: dict, max_norm: float):
    """``(the factor that clips the gradients to global norm max_norm, the
    global norm)``, both f32 device scalars."""
    gn = torch.sqrt(sum(g.to(torch.float32).square().sum()
                        for g in tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads: dict, max_norm: float):
    """``(grads scaled to global norm at most max_norm, in their dtypes;
    the global norm, f32)``."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gn


def adamw_update(params: dict, grads: dict, opt: OptState, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, wd=0.1, max_norm=1.0):
    """``(new params, new OptState, global norm before clipping)``, the
    gradients clipped as ``clip_by_global_norm`` clips them."""
    scale, gnorm = _clip_scale(grads, max_norm)
    step = opt.step + 1
    t = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=t.device), t)

    def upd(p, g, m, v):
        g32 = _clipped(g, scale).to(torch.float32)
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * g32.square()
        u = (m2 / c1) / (torch.sqrt(v2 / c2) + eps) + wd * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype), m2, v2

    def chunked(p, g, m, v):
        if p.is_meta:
            # the dry-run's accounting: a meta tensor holds no memory, and
            # a sharded one (a DTensor) keeps its layout leaf-whole
            return upd(p, g, m, v)
        new = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                    for x in (p, m, v))
        flat = [x.reshape(-1) for x in (p, g, m, v)]
        for i in range(0, p.numel(), CHUNK):
            for out, x in zip(new, upd(*(x[i:i + CHUNK] for x in flat))):
                out.view(-1)[i:i + CHUNK].copy_(x)
        return new

    params, m, v = tree_unzip(tree_map(chunked, params, grads, opt.m, opt.v),
                              3)
    return params, OptState(m=m, v=v, step=step), gnorm
