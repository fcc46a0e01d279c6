"""Autograd for the hand-written kernels: a forward through the kernel and a
backward through a backward kernel, or through the VJP of the kernel's plain
PyTorch version where the op has no backward kernel yet.

Counterpart of the JAX package's ``custom_vjp`` wrappers around its Pallas
kernels (``_corr_bwd``, ``_rf_bwd``, ``_hc_bwd``), whose backward passes are
``jax.vjp`` of the plain XLA forms. The forward runs the CUDA kernel on a
CUDA tensor and the plain version on a CPU tensor, without recording. The
backward of the cost volume and of the head conv runs their backward
kernels on a CUDA tensor (``csrc/correlation_bwd.cu``,
``csrc/headconv_bwd.cu``) and their closed-form plain backward on a CPU
tensor; the regularization filter's backward still recomputes its plain
version on the saved inputs with autograd on and returns its input
gradients, on either device.
"""

import torch
from torch.autograd.function import once_differentiable


def records_grad(*tensors):
    """True when autograd records and an input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_vjp(plain_fn, grad_out, saved, rest, needs):
    """Input gradients of ``plain_fn`` at the ``saved`` tensors for the
    cotangent ``grad_out``, through autograd (None where ``needs`` is
    False, zeros where the output does not depend on a needed input)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, needs)]
        out = plain_fn(*leaves, *rest)
        wrt = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
    ins = [next(grads) if need else None for need in needs]
    return [torch.zeros_like(t) if need and g is None else g
            for t, need, g in zip(saved, needs, ins)]


def kernel_function(name, kernel_fn, plain_fn, n_tensors, backward_fn=None,
                    backward_plain_fn=None):
    """A ``torch.autograd.Function`` whose ``apply`` takes the ``n_tensors``
    tensors of ``plain_fn`` (None for an absent optional one), then its other
    arguments, and returns ``kernel_fn`` of them on a CUDA device,
    ``plain_fn`` on the CPU.

    With ``backward_fn`` (a backward kernel's wrapper) and
    ``backward_plain_fn`` (its plain version), each called as
    ``fn(grad_out, *tensors, *other_args, needs=...)`` and returning one
    gradient per tensor (None where not needed), the backward launches
    ``backward_fn`` on a CUDA device and ``backward_plain_fn`` on the CPU;
    without them it is the VJP of ``plain_fn`` on either device. Its
    ``backward_calls`` counts the backward passes run."""

    def forward(ctx, *args):
        tensors = args[:n_tensors]
        ctx.save_for_backward(*tensors)
        ctx.rest = args[n_tensors:]
        fn = plain_fn if tensors[0].device.type == "cpu" else kernel_fn
        return fn(*args)

    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:n_tensors])
        if backward_fn is None:
            ins = plain_vjp(plain_fn, grad_out, saved, ctx.rest, needs)
        else:
            fn = backward_plain_fn if saved[0].device.type == "cpu" else backward_fn
            ins = fn(grad_out, *saved, *ctx.rest, needs=needs)
        fn_cls.backward_calls += 1
        return (*ins, *(None,) * len(ctx.rest))

    if backward_fn is not None:
        # the backward kernels record no graph of their own
        backward = once_differentiable(backward)
    fn_cls = type(name, (torch.autograd.Function,),
                  {"forward": staticmethod(forward), "backward": staticmethod(backward)})
    fn_cls.backward_calls = 0
    return fn_cls
