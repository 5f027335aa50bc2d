"""data_ms.train: host time inside the program's ``data/normalize_batch``
spans (``data/loader.py``, the copy of the uint8 batch to the device
included) of the profiled sub-window per step, in ms."""

from spans import ms_per_call

NAMES = ("data/normalize_batch",)


def read(obs):
    return ms_per_call(obs, "train", NAMES)
