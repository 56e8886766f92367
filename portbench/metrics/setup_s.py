"""setup_s: process start to the window's start (host clock): the kernel
library's load (its build on a checkout's first run), the weights, the
quantization, the embedders, the warm-up and, for a qa cell, the memory
the questions are asked of."""


def read(ctx):
    return ctx.setup_s
