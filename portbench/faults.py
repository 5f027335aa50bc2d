"""Faults planted under a cell's timed path, for the readings that a cell's
limits are held against (``calibrate.py --fault``) and for the CPU tests
that see ``correct`` come out false.  Each patches the port where the
drivers take it from, so the driver and the check run as in a real run.

- ``half_batch``: half of each batch left out; a sampler repeats the half it
  computed, a train step takes the mean over the rest;
- ``unchanged``: a train step that runs and reports its losses but returns
  its state unchanged;
- ``altered_answer``: one image of each sampler request altered where it is
  produced;
- ``ada_flipped``: ADA's p-controller (``ada_update``) steps p the wrong way.
"""

from __future__ import annotations

import contextlib
import copy

import torch

FAULTS = {"sample": ("half_batch", "altered_answer"),
          "biggan_train": ("half_batch", "unchanged"),
          "sg2_train": ("half_batch", "unchanged", "ada_flipped")}


def _broken_sampler(make, fault):
    def patched(*a, **kw):
        sampler = make(*a, **kw)

        def broken(z, label=None, feats=None, device_output=False):
            if fault == "half_batch":
                h = z.shape[0] // 2
                imgs = sampler(z[:h], label, None if feats is None else feats[:h],
                               device_output=True)
                return torch.cat([imgs, imgs])
            imgs = sampler(z, label, feats, device_output=True).clone()
            imgs[0] = imgs[0].flip(0)
            return imgs

        return broken

    return patched


def _broken_step(make, fault):
    def patched(*a, **kw):
        step = make(*a, **kw)

        def broken(state, batch, *rest, **kws):
            if fault == "unchanged":
                _, metrics = step(copy.deepcopy(state), batch, *rest, **kws)
                return state, metrics
            lead = 1 if batch["x"].dim() == 5 else 0   # slab batches: (micro, mb, ...)
            half = {k: v.narrow(lead, 0, v.shape[lead] // 2) for k, v in batch.items()}
            return step(state, half, *rest, **kws)

        return broken

    return patched


def _flipped_ada(update, fault):
    def patched(state, cfg, batch_size):
        before = state.ada_p
        state = update(state, cfg, batch_size)
        state.ada_p = torch.clamp_min(2 * before - state.ada_p, 0.0)
        return state

    return patched


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """Inside the block, the port's entry point that ``driver`` runs carries
    ``fault``."""
    if fault not in FAULTS[driver]:
        raise ValueError(f"driver {driver} has no fault {fault!r}")
    if driver == "sample":
        import ic_gan_tpu_torch.io.deploy as mod
        name, wrap = "make_sampler", _broken_sampler
    elif driver == "biggan_train":
        import ic_gan_tpu_torch.train.step as mod
        name, wrap = "make_train_step", _broken_step
    else:
        import ic_gan_tpu_torch.train.stylegan2_step as mod
        name, wrap = (("ada_update", _flipped_ada) if fault == "ada_flipped"
                      else ("make_sg2_train_step", _broken_step))
    original = getattr(mod, name)
    setattr(mod, name, wrap(original, fault))
    try:
        yield
    finally:
        setattr(mod, name, original)
