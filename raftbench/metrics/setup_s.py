"""setup_s: imports, the CUDA context, the kernel build's load (a
checkout's first run compiles it) and the warm-up universe, on the host
clock from the start of `raftbench.run`."""


def read(run):
    return run.setup_s
