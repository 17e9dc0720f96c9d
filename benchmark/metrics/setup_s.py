"""Seconds from process start to the window's first call: imports, CUDA
context, weights made on the card, the program's objects, the compared
steps and the warm-up (a cold checkout's first run also builds the
kernels). Host clock."""


def read(r):
    return r.setup_s
