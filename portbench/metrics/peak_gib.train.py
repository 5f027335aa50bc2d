"""peak_gib.train: ``torch.cuda.max_memory_allocated()`` once the window has
closed (the first rank's in a data-parallel cell), in GiB."""

from readers import peak_gib


def read(obs):
    return peak_gib(obs, "train")
