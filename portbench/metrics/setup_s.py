"""setup_s (s): everything before the window: imports, the CUDA context, the
kernels from the compile cache in the checkout, the instances, the warm-up
request and any base solve."""


def read(ctx):
    return ctx.setup_s
