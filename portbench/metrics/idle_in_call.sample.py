"""idle_in_call.sample: the device's idle time inside the program's
``sampler/call`` spans, as a percentage of the profiled sub-window; the rest
of ``device_idle.sample`` falls between calls."""

from spans import idle_inside

NAMES = ("sampler/call",)


def read(obs):
    return idle_inside(obs, "sample", NAMES)
