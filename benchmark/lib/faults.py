"""Faults planted under the timed path, for the self-test and for the
upper readings of a limit (``readings.py --faults``).

Each takes the step, a list of callables, and ``ctx`` (the program
``ft``, its operator ``op`` and the cell's ``traffic``), and returns the
broken step. The first three break any op; the solve faults break only a
``cg_normal`` op, and each returns a result that reports the iterations
asked for, so that only the residual it reaches can give it away.
"""
from __future__ import annotations

import random

import torch

from .reference import Solved, tensor_of

__all__ = ["FAULTS", "SOLVE_FAULTS"]


def unchanged(step, ctx):
    """Each op returns its input: a step that leaves its state as it was."""
    return [lambda x: x for _ in step]


def half(step, ctx):
    """Half of the operand's columns (or entries) left out."""
    def wrap(fn):
        def run(x):
            keep = tensor_of(x).clone()
            if keep.ndim == 1:
                keep[keep.shape[0] // 2:] = 0
            else:
                keep[:, keep.shape[1] // 2:] = 0
            return fn(keep)
        return run
    return [wrap(fn) for fn in step]


def altered(step, ctx):
    """One entry of each op's answer altered where it is produced."""
    def alter(y):
        y = y.clone()
        y.view(-1)[random.Random(len(y)).randrange(y.numel())] += 1.0
        return y

    def wrap(fn):
        def run(x):
            y = fn(x)
            if isinstance(y, tuple):
                return y._replace(x=alter(y.x))
            return alter(y)
        return run
    return [wrap(fn) for fn in step]


def _solve_fault(body):
    def fault(step, ctx):
        out = []
        for fn, s in zip(step, ctx.traffic["step"]):
            if s["op"] == "cg_normal":
                kw = {"reg": float(s["reg"]), "tol": float(s["tol"]),
                      "maxiter": int(s["maxiter"])}
                fn = (lambda x, kw=kw: body(ctx, tensor_of(x), **kw))
            out.append(fn)
        return out
    fault.__doc__ = body.__doc__
    return fault


def _norms(b):
    return torch.linalg.vector_norm(b, dim=0)


@_solve_fault
def solve_unchanged(ctx, b, reg, tol, maxiter):
    """x left at its start, x0 = 0, with its true residual ‖b‖."""
    return Solved(torch.zeros_like(b), _norms(b), maxiter)


@_solve_fault
def solve_short(ctx, b, reg, tol, maxiter):
    """Half of the iterations run, all of them reported."""
    r = ctx.ft.cg_normal(ctx.op, b, reg=reg, tol=tol, maxiter=maxiter // 2)
    return r._replace(iters=maxiter)


@_solve_fault
def solve_half(ctx, b, reg, tol, maxiter):
    """Half of the columns solved; the rest left at 0 with residual ‖b‖."""
    h = b.shape[1] // 2
    r = ctx.ft.cg_normal(ctx.op, b[:, :h].contiguous(), reg=reg, tol=tol,
                         maxiter=maxiter)
    x = torch.zeros_like(b)
    x[:, :h] = r.x
    return Solved(x, torch.cat([r.resnorm, _norms(b[:, h:])]), r.iters)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
SOLVE_FAULTS = {"solve_unchanged": solve_unchanged,
                "solve_short": solve_short, "solve_half": solve_half}
