"""Truncated exponential: exp with a clamped input and gradient.

Counterpart of autolabel_tpu/ops/activation.py. The density head
exponentiates raw MLP output; the forward clamps its input at 15 (sigma
<= 3.3e6, far past where compositing saturates) and the backward clips to
+-15, exactly as the JAX custom VJP does.
"""
import torch


class _TruncExp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=15.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)
