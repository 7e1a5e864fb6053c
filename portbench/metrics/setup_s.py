"""Set-up time: process start to the window's first job (host clock):
imports, CUDA, the kernel library (its nvcc build in a checkout's first
run) and the warm-up."""


def read(record):
    return record.setup_s
