"""Autograd for the hand-written kernels: a forward through the kernel and a
backward through a backward kernel.

Counterpart of the JAX package's ``custom_vjp`` wrappers around its Pallas
kernels (``_corr_bwd``, ``_rf_bwd``, ``_hc_bwd``), whose backward passes are
``jax.vjp`` of the plain XLA forms. The forward runs the CUDA kernel on a
CUDA tensor and the plain version on a CPU tensor, without recording. The
backward runs the op's backward kernel on a CUDA tensor
(``csrc/correlation_bwd.cu``, ``csrc/regfilter_bwd.cu``,
``csrc/headconv_bwd.cu``) and its closed-form plain backward on a CPU
tensor; neither records a graph.
"""

import torch
from torch.autograd.function import once_differentiable


def records_grad(*tensors):
    """True when autograd records and an input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def kernel_function(name, kernel_fn, plain_fn, n_tensors, backward_fn, backward_plain_fn):
    """A ``torch.autograd.Function`` whose ``apply`` takes the ``n_tensors``
    tensors of ``plain_fn`` (None for an absent optional one), then its other
    arguments, and returns ``kernel_fn`` of them on a CUDA device,
    ``plain_fn`` on the CPU.

    ``backward_fn`` (a backward kernel's wrapper) and ``backward_plain_fn``
    (its plain version) are each called as
    ``fn(grad_out, *tensors, *other_args, needs=...)`` and return one
    gradient per tensor (None where not needed); the backward launches
    ``backward_fn`` on a CUDA device and ``backward_plain_fn`` on the CPU.
    Its ``backward_calls`` counts the backward passes run."""

    def forward(ctx, *args):
        tensors = args[:n_tensors]
        ctx.save_for_backward(*tensors)
        ctx.rest = args[n_tensors:]
        fn = plain_fn if tensors[0].device.type == "cpu" else kernel_fn
        return fn(*args)

    @once_differentiable
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:n_tensors])
        fn = backward_plain_fn if saved[0].device.type == "cpu" else backward_fn
        ins = fn(grad_out, *saved, *ctx.rest, needs=needs)
        fn_cls.backward_calls += 1
        return (*ins, *(None,) * len(ctx.rest))

    fn_cls = type(name, (torch.autograd.Function,),
                  {"forward": staticmethod(forward), "backward": staticmethod(backward)})
    fn_cls.backward_calls = 0
    return fn_cls
