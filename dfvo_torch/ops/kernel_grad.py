"""Autograd for the hand-written kernels: a forward through the kernel and a
backward that is the VJP of the kernel's plain PyTorch version.

Counterpart of the JAX package's ``custom_vjp`` wrappers around its Pallas
kernels (``_corr_bwd``, ``_rf_bwd``, ``_hc_bwd``), whose backward passes are
``jax.vjp`` of the plain XLA forms. The forward runs the CUDA kernel on a
CUDA tensor and the plain version on a CPU tensor, without recording; the
backward recomputes the plain version on the saved inputs with autograd on
and returns its input gradients.
"""

import torch


def records_grad(*tensors):
    """True when autograd records and an input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def kernel_function(name, kernel_fn, plain_fn, n_tensors):
    """A ``torch.autograd.Function`` whose ``apply`` takes the ``n_tensors``
    tensors of ``plain_fn`` (None for an absent optional one), then its other
    arguments, and returns ``kernel_fn`` of them on a CUDA device,
    ``plain_fn`` on the CPU. Its ``backward_calls`` counts the backward
    passes run."""

    def forward(ctx, *args):
        tensors = args[:n_tensors]
        ctx.save_for_backward(*tensors)
        ctx.rest = args[n_tensors:]
        fn = plain_fn if tensors[0].device.type == "cpu" else kernel_fn
        return fn(*args)

    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:n_tensors]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, needs)]
            out = plain_fn(*leaves, *ctx.rest)
            wrt = [t for t, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
        ins = [next(grads) if need else None for need in needs]
        ins = [torch.zeros_like(t) if need and g is None else g
               for t, need, g in zip(saved, needs, ins)]
        fn_cls.backward_calls += 1
        return (*ins, *(None,) * len(ctx.rest))

    fn_cls = type(name, (torch.autograd.Function,),
                  {"forward": staticmethod(forward), "backward": staticmethod(backward)})
    fn_cls.backward_calls = 0
    return fn_cls
