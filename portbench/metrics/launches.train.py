"""launches.train: device kernels in the profiled sub-window per train step, over whole periods of the step schedule."""

from readers import launches


def read(obs):
    return launches(obs, "train")
