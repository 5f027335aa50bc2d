"""launches.sample: device kernels in the profiled sub-window per sampler call."""

from readers import launches


def read(obs):
    return launches(obs, "sample")
