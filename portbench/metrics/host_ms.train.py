"""host_ms.train: host time inside the program's train-step spans
(``train/step.py``'s ``train_step``, ``train/stylegan2_step.py``'s
``sg2_step/<variant>``; the outermost only) of the profiled sub-window per
step, in ms."""

from spans import STEP_SPANS, ms_per_call


def read(obs):
    return ms_per_call(obs, "train", STEP_SPANS)
