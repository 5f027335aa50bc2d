"""device_idle.train: the share of the profiled sub-window in which no device
activity ran, in percent."""

from readers import device_idle


def read(obs):
    return device_idle(obs, "train")
