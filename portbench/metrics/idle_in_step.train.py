"""idle_in_step.train: the device's idle time inside the program's
train-step spans, as a percentage of the profiled sub-window;
``device_idle.train`` less this is the idle that falls between steps (the
loop and the feed)."""

from spans import STEP_SPANS, idle_inside


def read(obs):
    return idle_inside(obs, "train", STEP_SPANS)
