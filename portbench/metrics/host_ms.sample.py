"""host_ms.sample: host time inside the program's ``sampler/call`` spans of
the profiled sub-window (``io/deploy.py:make_sampler``) per call, in ms.  A
call that leaves its images on the device returns once its work is queued,
so this is the host's share of a request."""

from spans import ms_per_call

NAMES = ("sampler/call",)


def read(obs):
    return ms_per_call(obs, "sample", NAMES)
