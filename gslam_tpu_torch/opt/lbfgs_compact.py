"""Adam warm-up + L-BFGS with strong-Wolfe line search, one evaluation site.

Counterpart of gslam_tpu/opt/lbfgs_compact.py, with the same state machine
(modes WARMUP, INIT, TRIAL, ZOOM, DONE; history ring; two-loop recursion;
cubic-interpolation bracket and zoom; first step scaled lr*min(1, 1/|g|_1))
and the same evaluation count: warm-up and L-BFGS evaluations share one
budget of warmup_steps + 1 + max_eval.

The JAX loop is a fixed-length scan that keeps evaluating after DONE but
stops updating its state; this eager loop stops at DONE instead, which
leaves x, f and n_evals the same. Each update branches in Python on scalars
read back to the host once per evaluation. The state is a few vectors of
the problem's size, kept in float32 on x0's device; a caller whose loss
runs on the card can keep x0 on the CPU so that the branch logic costs no
kernel launches (the gradient comes back to x0's device through autograd).

Spans (runtime/trace.py): `track.optimizer` around the whole loop, and per
evaluation `track.eval` holding the loss function's own spans, then
`track.backward` (autograd.grad) and `track.readback` (the loss to x0's
device); the counter `track.evals` adds one an evaluation.
"""

from __future__ import annotations

from typing import Callable

import torch

from gslam_tpu_torch.runtime import trace

WARMUP, INIT, TRIAL, ZOOM, DONE = 0, 1, 2, 3, 4

C1 = 1e-4
C2 = 0.9


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_sq = d1 * d1 - g1 * g2
    ok = d2_sq >= 0
    d2 = torch.sqrt(torch.where(ok, d2_sq, 0.0)) * torch.sign(x2 - x1)
    t = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
    t = torch.where(ok & torch.isfinite(t), t, 0.5 * (lo + hi))
    return torch.minimum(torch.maximum(t, lo), hi)


class _State:
    """Mutable optimizer state; scalar fields are float32 0-dim tensors."""

    def __init__(self, x0: torch.Tensor, history: int, warmup_steps: int):
        dim = x0.shape[0]
        kw = dict(dtype=torch.float32, device=x0.device)

        def zero():
            return torch.zeros((), **kw)

        def vec():
            return torch.zeros(dim, **kw)

        self.mode = WARMUP if warmup_steps > 0 else INIT
        self.x = x0.detach().to(torch.float32)
        self.f = torch.tensor(float("inf"), **kw)
        self.g, self.d = vec(), vec()
        self.dd0, self.t = zero(), zero()
        # previous trial (bracket phase)
        self.t_prev, self.f_prev, self.d_prev = zero(), zero(), zero()
        self.g_prev = vec()
        # zoom bracket
        self.t_lo, self.f_lo, self.dd_lo = zero(), zero(), zero()
        self.g_lo = vec()
        self.t_hi, self.f_hi, self.dd_hi = zero(), zero(), zero()
        self.insuf = False
        # history ring
        self.S = torch.zeros((history, dim), **kw)
        self.Y = torch.zeros((history, dim), **kw)
        self.rho = torch.zeros(history, **kw)
        self.hist = 0
        # adam moments (warm-up)
        self.mu, self.nu = vec(), vec()
        # counters
        self.n_evals = 0
        self.it = 0
        self.warm = 0


def _direction(c: _State) -> torch.Tensor:
    """Two-loop recursion over the c.hist valid history entries."""
    q = -c.g
    if c.hist == 0:
        return q
    alpha = [None] * c.hist
    for idx in range(c.hist - 1, -1, -1):
        a = c.rho[idx] * torch.dot(c.S[idx], q)
        q = q - a * c.Y[idx]
        alpha[idx] = a
    newest = c.hist - 1
    gamma = torch.dot(c.S[newest], c.Y[newest]) / torch.clamp(
        torch.dot(c.Y[newest], c.Y[newest]), min=1e-10)
    q = q * gamma
    for i in range(c.hist):
        b = c.rho[i] * torch.dot(c.Y[i], q)
        q = q + (alpha[i] - b) * c.S[i]
    return q


def warmup_lbfgs_impl(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    warmup_steps: int = 10,
    max_iter: int = 20,
    max_eval: int = 25,
    history: int = 5,
    lr: float = 1.0,
    warmup_lr: float | None = None,
    tol_grad: float = 1e-7,
    tol_change: float = 1e-9,
):
    """Returns (x, f, total_evals). Total budget = warmup + 1 + max_eval."""
    wlr = lr if warmup_lr is None else warmup_lr
    budget = warmup_steps + 1 + max_eval
    c = _State(x0, history, warmup_steps)

    def fg(p):
        with trace.span("track.eval"):
            trace.count("track.evals")
            p = p.detach().requires_grad_(True)
            f = loss_fn(p)
            with trace.span("track.backward"):
                (g,) = torch.autograd.grad(f, p)
            with trace.span("track.readback"):
                return f.detach().to(device=p.device, dtype=torch.float32), g.detach()

    def start_search(x_new, f_new, g_new):
        """Accept x_new as the new iterate and set up the next line search."""
        s = x_new - c.x
        y = g_new - c.g
        ys = torch.dot(y, s)
        if bool((ys > 1e-10) & torch.isfinite(ys)) and c.mode != INIT:
            idx = min(c.hist, history - 1)
            if c.hist >= history:
                c.S, c.Y = torch.roll(c.S, -1, 0), torch.roll(c.Y, -1, 0)
                c.rho = torch.roll(c.rho, -1)
            c.S[idx], c.Y[idx], c.rho[idx] = s, y, 1.0 / ys
            c.hist = min(c.hist + 1, history)
        c.x, c.f, c.g = x_new, f_new, g_new

        d = _direction(c)
        dd0 = torch.dot(g_new, d)
        if c.it == 0:
            t_init = torch.clamp(
                1.0 / torch.clamp(torch.sum(torch.abs(g_new)), min=1e-10), max=1.0
            ) * lr
        else:
            t_init = torch.tensor(lr, dtype=torch.float32, device=c.x.device)
        done = (
            bool(torch.max(torch.abs(g_new)) <= tol_grad)
            or bool(dd0 > -tol_change)
            or c.it + 1 > max_iter
        )
        c.mode = DONE if done else TRIAL
        c.d, c.dd0, c.t = d, dd0, t_init
        c.t_prev = torch.zeros_like(dd0)
        c.f_prev, c.d_prev, c.g_prev = f_new, dd0, g_new
        c.it += 1

    def do_warmup(g):
        t = torch.tensor(float(c.warm + 1), dtype=torch.float32, device=c.x.device)
        c.mu = 0.9 * c.mu + 0.1 * g
        c.nu = 0.999 * c.nu + 0.001 * g * g
        step = wlr * (c.mu / (1 - 0.9**t)) / (
            torch.sqrt(c.nu / (1 - 0.999**t)) + 1e-8)
        c.x = c.x - step
        c.warm += 1
        c.mode = INIT if c.warm >= warmup_steps else WARMUP

    def do_trial(f, g, dd):
        armijo_fail = bool(
            (f > c.f + C1 * c.t * c.dd0) | ((c.t_prev > 0) & (f >= c.f_prev)))
        if armijo_fail:  # bracket [prev, cur]
            c.mode = ZOOM
            c.t_lo, c.f_lo, c.dd_lo, c.g_lo = c.t_prev, c.f_prev, c.d_prev, c.g_prev
            c.t_hi, c.f_hi, c.dd_hi = c.t, f, dd
        elif bool(torch.abs(dd) <= -C2 * c.dd0):  # strong Wolfe holds
            start_search(c.x + c.t * c.d, f, g)
        elif bool(dd >= 0):  # bracket [cur, prev]
            c.mode = ZOOM
            c.t_lo, c.f_lo, c.dd_lo, c.g_lo = c.t, f, dd, g
            c.t_hi, c.f_hi, c.dd_hi = c.t_prev, c.f_prev, c.d_prev
        else:  # extrapolate
            lo = c.t + 0.01 * (c.t - c.t_prev)
            hi = c.t * 10.0
            t_new = _cubic_min(c.t_prev, c.f_prev, c.d_prev, c.t, f, dd, lo, hi)
            c.t_prev, c.f_prev, c.d_prev, c.g_prev = c.t, f, dd, g
            c.t = t_new

    def do_zoom(f, g, dd):
        # c.t was the zoom trial; classify the fresh (f, g, dd)
        armijo_fail = bool((f > c.f + C1 * c.t * c.dd0) | (f >= c.f_lo))
        if armijo_fail:
            c.t_hi, c.f_hi, c.dd_hi = c.t, f, dd
        elif bool(torch.abs(dd) <= -C2 * c.dd0):
            start_search(c.x + c.t * c.d, f, g)
        else:
            if bool(dd * (c.t_hi - c.t_lo) >= 0):
                c.t_hi, c.f_hi, c.dd_hi = c.t_lo, c.f_lo, c.dd_lo
            c.t_lo, c.f_lo, c.dd_lo, c.g_lo = c.t, f, dd, g
        if c.mode != ZOOM:
            return
        lo = torch.minimum(c.t_lo, c.t_hi)
        hi = torch.maximum(c.t_lo, c.t_hi)
        gap = hi - lo
        t_new = _cubic_min(c.t_lo, c.f_lo, c.dd_lo, c.t_hi, c.f_hi, c.dd_hi, lo, hi)
        eps = 0.1 * gap
        close = bool(torch.minimum(hi - t_new, t_new - lo) < eps)
        if close and (c.insuf or bool(t_new >= hi) or bool(t_new <= lo)):
            t_new = hi - eps if bool(t_new > 0.5 * (lo + hi)) else lo + eps
        if bool(gap * torch.abs(c.dd0) < tol_change):
            # the bracket collapsed: give up the search and accept t_lo
            start_search(c.x + c.t_lo * c.d, c.f_lo, c.g_lo)
        else:
            c.t, c.insuf = t_new, close

    with trace.span("track.optimizer"):
        while c.mode != DONE and c.n_evals < budget:
            p = c.x if c.mode in (WARMUP, INIT) else c.x + c.t * c.d
            f, g = fg(p)
            dd = torch.dot(g, c.d)
            c.n_evals += 1
            if c.mode == WARMUP:
                do_warmup(g)
            elif c.mode == INIT:
                c.mode, c.f, c.g = INIT, f, g
                start_search(c.x, f, g)
            elif c.mode == TRIAL:
                do_trial(f, g, dd)
            else:
                do_zoom(f, g, dd)
        return c.x, c.f, c.n_evals


# The JAX package's public entry point is warmup_lbfgs_impl under jit; an
# eager loop needs no wrapper.
warmup_lbfgs = warmup_lbfgs_impl
