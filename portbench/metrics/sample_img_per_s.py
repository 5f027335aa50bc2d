"""sample_img_per_s: every image the window's requests produced, over the
whole window (host clock, the window ending when its last request's images
are on the device)."""


def read(obs):
    if obs.get("kind") != "sample" or obs["window_s"] <= 0:
        return None
    return obs["images"] / obs["window_s"]
