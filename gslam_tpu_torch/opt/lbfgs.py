"""L-BFGS with a strong-Wolfe line search, as an eager host loop.

Counterpart of gslam_tpu/opt/lbfgs.py (`lbfgs_impl`, `_strong_wolfe`,
`_cubic_min`), with the same defaults (c1 1e-4, c2 0.9), the same
bracket-and-zoom search with its 10% progress safeguard, the same
history update and the same termination tests. The JAX version is one
`lax.while_loop` program; here each branch is a Python branch on scalars
kept on the CPU.

The optimizer state (x, f, g, the history) lives on the CPU in float32.
The loss runs on x0's device: an evaluation moves x there, takes the loss
and its gradient by autograd, and reads both back to the host in one copy
of [f, g]. So `n_evals` also counts the readbacks.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import torch

from gslam_tpu_torch.opt.lbfgs_compact import C1, C2, _cubic_min, _direction


class LbfgsResult(NamedTuple):
    x: torch.Tensor  # [D] on x0's device
    f: torch.Tensor  # [] on x0's device
    g: torch.Tensor  # [D] on x0's device
    n_evals: int  # loss/gradient evaluations, one host readback each
    n_iters: int


def value_and_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor], device):
    """fg(x_host) -> (f, g) on the CPU: the loss and its gradient at x, taken
    on `device` and read back together."""

    def fg(x: torch.Tensor):
        p = x.detach().to(device).requires_grad_(True)
        f = loss_fn(p)
        (g,) = torch.autograd.grad(f, p)
        fg_host = torch.cat([f.detach().reshape(1), g.detach()]).to("cpu", torch.float32)
        return fg_host[0], fg_host[1:]

    return fg


def _strong_wolfe(fg, x, d, t0, f0, g0, c1: float = C1, c2: float = C2,
                  max_ls: int = 25, tol_change: float = 1e-9):
    """Find t satisfying strong Wolfe along d from x. Returns (f, g, t, evals)."""
    dd0 = torch.dot(g0, d)

    def eval_at(t):
        f, g = fg(x + t * d)
        return f, g, torch.dot(g, d)

    f1, g1, dd1 = eval_at(t0)
    zero = torch.zeros_like(t0)
    # the bracket: (t, f, directional derivative, g) at its low and high
    # ends, the current trial and the previous one
    c = SimpleNamespace(t_lo=zero, f_lo=f0, d_lo=dd0, g_lo=g0,
                        t_hi=t0, f_hi=f1, d_hi=dd1, g_hi=g1,
                        t=t0, f=f1, dd=dd1, g=g1,
                        t_prev=zero, f_prev=f0, d_prev=dd0, g_prev=g0,
                        n_evals=1, stage=0, insuf=False)

    def bracket_step():
        armijo_fail = bool((c.f > f0 + c1 * c.t * dd0) | ((c.n_evals > 1) & (c.f >= c.f_prev)))
        if armijo_fail:  # bracket [prev, cur]
            c.t_lo, c.f_lo, c.d_lo, c.g_lo = c.t_prev, c.f_prev, c.d_prev, c.g_prev
            c.t_hi, c.f_hi, c.d_hi, c.g_hi = c.t, c.f, c.dd, c.g
            c.stage = 1
        elif bool(torch.abs(c.dd) <= -c2 * dd0):  # strong Wolfe holds
            c.t_lo, c.f_lo, c.d_lo, c.g_lo = c.t, c.f, c.dd, c.g
            c.stage = 2
        elif bool(c.dd >= 0):  # bracket [cur, prev]
            c.t_lo, c.f_lo, c.d_lo, c.g_lo = c.t, c.f, c.dd, c.g
            c.t_hi, c.f_hi, c.d_hi, c.g_hi = c.t_prev, c.f_prev, c.d_prev, c.g_prev
            c.stage = 1
        else:  # extrapolate beyond t
            min_step = c.t + 0.01 * (c.t - c.t_prev)
            max_step = c.t * 10.0
            t_new = _cubic_min(c.t_prev, c.f_prev, c.d_prev, c.t, c.f, c.dd,
                               min_step, max_step)
            f_new, g_new, dd_new = eval_at(t_new)
            c.t_prev, c.f_prev, c.d_prev, c.g_prev = c.t, c.f, c.dd, c.g
            c.t, c.f, c.dd, c.g = t_new, f_new, dd_new, g_new
            c.n_evals += 1

    def zoom_step():
        lo_t = torch.minimum(c.t_lo, c.t_hi)
        hi_t = torch.maximum(c.t_lo, c.t_hi)
        gap = hi_t - lo_t
        t_new = _cubic_min(c.t_lo, c.f_lo, c.d_lo, c.t_hi, c.f_hi, c.d_hi, lo_t, hi_t)
        # torch-style progress safeguard: if the interpolation lands within
        # 10% of a boundary twice in a row, bisect
        eps = 0.1 * gap
        close = bool(torch.minimum(hi_t - t_new, t_new - lo_t) < eps)
        if close and (c.insuf or bool(t_new >= hi_t) or bool(t_new <= lo_t)):
            t_new = hi_t - eps if bool(t_new > 0.5 * (lo_t + hi_t)) else lo_t + eps

        f_new, g_new, dd_new = eval_at(t_new)
        if bool((f_new > f0 + c1 * t_new * dd0) | (f_new >= c.f_lo)):  # shrink hi
            c.t_hi, c.f_hi, c.d_hi, c.g_hi = t_new, f_new, dd_new, g_new
        else:  # move lo
            wolfe_ok = bool(torch.abs(dd_new) <= -c2 * dd0)
            if bool(dd_new * (c.t_hi - c.t_lo) >= 0) and not wolfe_ok:
                c.t_hi, c.f_hi, c.d_hi, c.g_hi = c.t_lo, c.f_lo, c.d_lo, c.g_lo
            c.t_lo, c.f_lo, c.d_lo, c.g_lo = t_new, f_new, dd_new, g_new
            if wolfe_ok:
                c.stage = 2
        c.n_evals += 1
        c.insuf = close
        if bool(gap * torch.abs(dd0) < tol_change):
            c.stage = 2

    while c.stage < 2 and c.n_evals < max_ls:
        if c.stage == 0:
            bracket_step()
        else:
            zoom_step()
    return c.f_lo, c.g_lo, c.t_lo, c.n_evals


class _History:
    """The two-loop recursion's inputs (lbfgs_compact._direction reads g,
    hist, S, Y and rho): history stored ring-free, index hist-1 newest."""

    def __init__(self, g, history: int):
        dim = g.shape[0]
        self.g = g
        self.S = torch.zeros((history, dim))
        self.Y = torch.zeros((history, dim))
        self.rho = torch.zeros(history)
        self.hist = 0

    def push(self, s, y, ys, history: int):
        if self.hist >= history:
            self.S = torch.cat([self.S[1:], s[None]])
            self.Y = torch.cat([self.Y[1:], y[None]])
            self.rho = torch.cat([self.rho[1:], (1.0 / ys)[None]])
        else:
            self.S[self.hist], self.Y[self.hist], self.rho[self.hist] = s, y, 1.0 / ys
        self.hist = min(self.hist + 1, history)


def lbfgs_impl(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iter: int = 20,
    max_eval: int = 25,
    history: int = 5,
    lr: float = 1.0,
    tol_grad: float = 1e-7,
    tol_change: float = 1e-9,
) -> LbfgsResult:
    """Minimize loss_fn from x0 (flat [D] vector); loss_fn runs on x0's device."""
    dev = x0.device
    fg = value_and_grad(loss_fn, dev)
    x = x0.detach().to("cpu", torch.float32)
    f, g = fg(x)
    c = _History(g, history)
    n_evals, it = 1, 0
    done = bool(torch.max(torch.abs(g)) <= tol_grad)
    while not done and it < max_iter and n_evals < max_eval:
        c.g = g
        d = _direction(c)
        dd = torch.dot(g, d)
        if it == 0:
            t_init = torch.clamp(1.0 / torch.clamp(torch.sum(torch.abs(g)), min=1e-10),
                                 max=1.0) * lr
        else:
            t_init = torch.tensor(lr, dtype=torch.float32)
        f_new, g_new, t, ls_evals = _strong_wolfe(fg, x, d, t_init, f, g,
                                                  tol_change=tol_change)
        x_new = x + t * d
        s = x_new - x
        y = g_new - g
        ys = torch.dot(y, s)
        if bool(ys > 1e-10):
            c.push(s, y, ys, history)
        done = (bool(torch.max(torch.abs(g_new)) <= tol_grad)
                or bool(torch.max(torch.abs(t * d)) <= tol_change)
                or bool(torch.abs(f_new - f) < tol_change)
                or bool(dd > -tol_change))
        x, f, g = x_new, f_new, g_new
        n_evals += ls_evals
        it += 1
    return LbfgsResult(x=x.to(dev), f=f.to(dev), g=g.to(dev), n_evals=n_evals, n_iters=it)


# The JAX package's public entry point is lbfgs_impl under jit; an eager
# loop needs no wrapper.
lbfgs = lbfgs_impl
