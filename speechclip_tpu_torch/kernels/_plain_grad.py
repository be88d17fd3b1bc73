"""The kernels' backward: a recompute through their plain versions.

Each JAX kernel with a gradient is a ``jax.custom_vjp`` whose ``_fwd`` runs
the Pallas kernel and saves its inputs, and whose ``_bwd`` takes ``jax.vjp``
of an XLA restatement of the same math. ``plain_grad_function`` builds the
port's counterpart, one ``torch.autograd.Function`` per kernel: ``forward``
runs the wrapper's device dispatch (the hand-written kernel on a CUDA
tensor, the plain version on a CPU tensor) and saves the inputs;
``backward`` recomputes the plain version under ``torch.enable_grad()``
and returns ``torch.autograd.grad`` of it for the upstream gradient. So the
gradient through the Function is, bit for bit, the plain version's own.
Arguments that are not tensors (head counts, modes, flags) and integer
tensors (key lengths) get no gradient.
"""

from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and torch.is_tensor(t) and t.requires_grad for t in tensors)


def plain_grad_function(name: str, dispatch: Callable, plain: Callable,
                        owner: Callable) -> type:
    """A ``torch.autograd.Function`` named ``name`` whose forward is
    ``dispatch(*args)`` and whose backward recomputes ``plain(*args)``;
    ``owner`` is the kernel's wrapper, whose ``recomputes`` count each
    backward adds one to (its ``launches`` count only kernel launches)."""

    def forward(ctx, *args):
        ctx.slots = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.constants = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.slots))
        return dispatch(*args)

    def backward(ctx, grad_out):
        args = list(ctx.constants)
        wrt = []
        with torch.enable_grad():
            for i, t in zip(ctx.slots, ctx.saved_tensors):
                if ctx.needs_input_grad[i]:
                    t = t.detach().requires_grad_(True)
                    wrt.append(i)
                args[i] = t
            out = plain(*args)
            grads = torch.autograd.grad(out, [args[i] for i in wrt], grad_out)
        owner.recomputes += 1
        result = [None] * len(args)
        for i, g in zip(wrt, grads):
            result[i] = g
        return tuple(result)

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward),
        "__doc__": f"{name}: the kernel forward, the plain version's gradient."})
