"""ada_ms.train: host time inside the program's ``data/ada_pipe`` spans
(``data/ada.py:AugmentPipe``, forward only; its backward runs under the
step's autograd) of the profiled sub-window per step, in ms."""

from spans import ms_per_call

NAMES = ("data/ada_pipe",)


def read(obs):
    return ms_per_call(obs, "train", NAMES)
