"""Optimizers (port of ``repro/optim/optimizers.py``): SGD with momentum,
RMSProp and Adam.

The JAX package's functional API on nested dicts of tensors:
``init(params) -> state`` and ``update(grads, state, params, step) ->
(new_params, new_state)``; states mirror the params, so they stack like
the stage weights.  ``update_`` applies the same arithmetic leaf by
leaf and writes the results into ``params`` and ``state`` in place,
which keeps the temporaries to one leaf (the executor's path).  The
rounding order is JAX's: state in ``state_dtype`` (f32), the step
cast to the parameter's dtype *before* the subtraction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

LR = Union[float, Callable[[int], float]]
#: elements of a leaf that ``update_`` updates at a time
CHUNK = 1 << 24


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally nested dicts."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _lr_at(lr: LR, step):
    return lr(step) if callable(lr) else lr


class _Optimizer:
    slots: tuple = ()
    state_dtype: torch.dtype = torch.float32

    def init(self, params):
        return {slot: tree_map(
            lambda p: torch.zeros(p.shape, dtype=self.state_dtype,
                                  device=p.device), params)
            for slot in self.slots}

    def _leaf(self, g, slots, p, step):
        raise NotImplementedError

    def update(self, grads, state, params, step=0):
        flat = tree_map(lambda g, p, *s: self._leaf(g, s, p, step),
                        grads, params, *(state[k] for k in self.slots))
        is_out = lambda t: isinstance(t, tuple)   # noqa: E731

        def pick(i, node):
            if is_out(node):
                return node[i]
            return {k: pick(i, v) for k, v in node.items()}
        return pick(0, flat), {k: pick(i + 1, flat)
                               for i, k in enumerate(self.slots)}

    def update_(self, grads, state, params, step=0) -> None:
        """:meth:`update`, written into ``params`` and ``state`` in place,
        leaf by leaf and :data:`CHUNK` elements at a time (the arithmetic
        is elementwise, so the result is the functional update's, bit for
        bit, with temporaries of one chunk)."""
        def leaf(g, p, *s):
            flat = [g.reshape(-1), p.view(-1), *(x.view(-1) for x in s)]
            for i in range(0, p.numel(), CHUNK):
                gc, pc, *sc = (t[i:i + CHUNK] for t in flat)
                new_p, *new_s = self._leaf(gc, sc, pc, step)
                pc.copy_(new_p)
                for dst, src in zip(sc, new_s):
                    dst.copy_(src)
        tree_map(leaf, grads, params, *(state[k] for k in self.slots))


@dataclasses.dataclass(frozen=True)
class SGDM(_Optimizer):
    """SGD with momentum (paper: momentum 0.9, lr 0.01 for VGG16/S2VT)."""

    lr: LR = 0.01
    momentum: float = 0.9
    state_dtype: torch.dtype = torch.float32
    slots = ("v",)

    def _leaf(self, g, slots, p, step):
        v_new = self.momentum * slots[0] + g.to(slots[0].dtype)
        return p - _lr_at(self.lr, step) * v_new.to(p.dtype), v_new


@dataclasses.dataclass(frozen=True)
class RMSProp(_Optimizer):
    """RMSProp (paper: Inception-v3, lr 0.045, decay 0.9, eps 1.0)."""

    lr: LR = 0.045
    decay: float = 0.9
    eps: float = 1.0
    state_dtype: torch.dtype = torch.float32
    slots = ("s",)

    def _leaf(self, g, slots, p, step):
        s = slots[0]
        g32 = g.to(s.dtype)
        s_new = self.decay * s + (1 - self.decay) * g32 * g32
        step_v = _lr_at(self.lr, step) * g32 / (torch.sqrt(s_new) + self.eps)
        return p - step_v.to(p.dtype), s_new


@dataclasses.dataclass(frozen=True)
class Adam(_Optimizer):
    lr: LR = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    state_dtype: torch.dtype = torch.float32
    slots = ("m", "v")

    def _leaf(self, g, slots, p, step):
        m, v = slots
        # bias corrections from b ** t in f32, as JAX computes them (the
        # host scalars round to f32 where they meet the f32 moments)
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        c1, c2 = (1.0 - float(torch.pow(torch.tensor(b, dtype=torch.float32),
                                        t)) for b in (self.b1, self.b2))
        g32 = g.to(m.dtype)
        m_new = self.b1 * m + (1 - self.b1) * g32
        v_new = self.b2 * v + (1 - self.b2) * g32 * g32
        step_v = _lr_at(self.lr, step) * (m_new / c1) / (
            torch.sqrt(v_new / c2) + self.eps)
        return p - step_v.to(p.dtype), m_new, v_new


Optimizer = Union[SGDM, RMSProp, Adam]


def by_name(name: str, lr: LR, **kw) -> Optimizer:
    return {"sgdm": SGDM, "rmsprop": RMSProp, "adam": Adam}[name](lr=lr, **kw)
