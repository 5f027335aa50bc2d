"""setup_s: seconds from the process's start to the start of the measured
window: imports, CUDA start-up, loading (the first run in a checkout:
building) the kernels, the weights from the seed, warm-up at the cell's
shapes and, in a train cell, the first steps that the reference follows."""


def read(obs):
    return obs.get("setup_s")
