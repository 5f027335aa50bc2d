"""train_img_per_s: real images consumed by the window's train steps (over
all ranks), over the whole window, which ends when its last step has
finished on the device.  s/kimg is 1000 / this."""


def read(obs):
    if obs.get("kind") != "train" or obs["window_s"] <= 0:
        return None
    return obs["images"] / obs["window_s"]
