"""Load reference StyleGAN2-ADA network pickles into the port: port of
``ic_gan_tpu/io/stylegan_import.py``.

The port's StyleGAN2 modules carry upstream's names and layouts (``mapping.
fc0``, ``synthesis.b{res}.conv0``, ``b4.out`` …; OIHW convs, (out, in)
linears, ``const`` (C, H, W)), so a torch snapshot's ``state_dict()`` loads
as it is but for the ``resample_filter`` buffers, which the port keeps as
constants of the architecture (``convert_state_dict``).  Legacy TF pickles
are read with a stub unpickler, without TensorFlow, and their variables
renamed and relaid by the rules of upstream's ``legacy.py``
(``convert_tf_generator``, ``convert_tf_discriminator``; numpy only).
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn


def convert_state_dict(torch_sd: Dict[str, object],
                       target: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A flat upstream state dict (tensors or numpy arrays) → the port's:
    CPU tensors under the same names, ``resample_filter`` dropped, ``w_avg``
    and ``noise_const`` kept.  With ``target``, every name and shape is
    checked against ``target.state_dict()`` (a ``KeyError`` or
    ``ValueError`` names the first mismatch)."""
    out = {}
    for key, val in torch_sd.items():
        if key.rsplit(".", 1)[-1] == "resample_filter":
            continue
        t = val.detach() if torch.is_tensor(val) else torch.from_numpy(np.array(val))
        out[key] = t.cpu().contiguous()
    if target is not None:
        want = target.state_dict()
        missing, extra = sorted(set(want) - set(out)), sorted(set(out) - set(want))
        if missing or extra:
            raise KeyError(f"state dict names differ from the target's: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}")
        for key, t in out.items():
            if tuple(t.shape) != tuple(want[key].shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)}, the target's "
                                 f"{tuple(want[key].shape)}")
    return out


class _TFNetworkStub:
    """Attribute bag standing in for the TF ``dnnlib.tflib.network.Network``
    during unpickling (ref ``legacy.py:82-90``): the pickled state is a plain
    dict (version / static_kwargs / variables / components) that lands in
    ``__dict__`` — no TensorFlow needed to read the weights."""


class _EasyDictStub(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)


class _StubUnpickler(pickle.Unpickler):
    """Resolve legacy ``dnnlib`` globals without importing TF or the
    reference package (ref ``legacy.py:85-89``)."""

    def find_class(self, module, name):
        if module.startswith("dnnlib") and name == "Network":
            return _TFNetworkStub
        if module.startswith("dnnlib") and name == "EasyDict":
            return _EasyDictStub
        return super().find_class(module, name)


def _collect_tf_params(tf_net) -> Dict[str, np.ndarray]:
    """Flatten a TF network stub's variables, prefixing component paths
    (ref ``legacy.py:95-106``)."""
    out = {}

    def recurse(prefix, net):
        for name, value in getattr(net, "variables", []):
            out[prefix + name] = np.asarray(value)
        for name, comp in getattr(net, "components", {}).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return out


def _tf_kwargs(tf_net, spec):
    """static_kwargs → torch-style init kwargs; reject unknown keys like the
    reference does (``legacy.py:146-181``) so silent misconfigs can't load."""
    kw = dict(getattr(tf_net, "static_kwargs", {}))
    known = set()

    def take(name, default=None):
        known.add(name)
        return kw.get(name, default)

    out = spec(take)
    unknown = set(kw) - known
    if unknown:
        raise ValueError(f"Unknown TensorFlow kwarg {sorted(unknown)[0]!r}")
    return out


def _conv_w(v):   # HWIO → OIHW
    return np.ascontiguousarray(v.transpose(3, 2, 0, 1))


def convert_tf_generator(tf_G):
    """TF StyleGAN2(-ADA) generator stub → (upstream-name state dict of numpy
    arrays, init kwargs).  Name and layout mapping as ``legacy.py:134-266``:
    TF stores conv kernels HWIO and FC kernels (in, out); up-convs and Skip
    taps are spatially flipped going to torch; ``mod_bias`` shifts by +1
    (torch folds the styles' unit bias into the affine)."""
    if getattr(tf_G, "version", 0) < 4:
        raise ValueError("TensorFlow pickle version too low")

    def spec(take):
        kwargs = dict(
            z_dim=take("latent_size", 512),
            c_dim=take("label_size", 0),
            w_dim=take("dlatent_size", 512),
            img_resolution=take("resolution", 1024),
            img_channels=take("num_channels", 3),
            mapping_kwargs=dict(
                num_layers=take("mapping_layers", 8),
                embed_features=take("label_fmaps"),
                layer_features=take("mapping_fmaps"),
                activation=take("mapping_nonlinearity", "lrelu"),
                lr_multiplier=take("mapping_lrmul", 0.01),
                w_avg_beta=take("w_avg_beta", 0.995) or 1,
            ),
            synthesis_kwargs=dict(
                channel_base=take("fmap_base", 16384) * 2,
                channel_max=take("fmap_max", 512),
                num_fp16_res=take("num_fp16_res", 0),
                conv_clamp=take("conv_clamp"),
                architecture=take("architecture", "skip"),
                resample_filter=take("resample_kernel", [1, 3, 3, 1]),
                use_noise=take("use_noise", True),
                activation=take("nonlinearity", "lrelu"),
            ),
        )
        for ignored in ("truncation_psi", "truncation_cutoff",
                        "style_mixing_prob", "structure"):
            take(ignored)
        return kwargs

    kwargs = _tf_kwargs(tf_G, spec)
    tf_params = _collect_tf_params(tf_G)
    # Progressive-growth snapshots name per-lod ToRGB heads; fold them back
    # onto their resolution and switch to 'orig' (no skip connections).
    for name in list(tf_params):
        m = re.fullmatch(r"ToRGB_lod(\d+)/(.*)", name)
        if m:
            r = kwargs["img_resolution"] // (2 ** int(m.group(1)))
            tf_params[f"{r}x{r}/ToRGB/{m.group(2)}"] = tf_params.pop(name)
            kwargs["synthesis_kwargs"]["architecture"] = "orig"

    def up_w(v):
        return np.ascontiguousarray(v[::-1, ::-1].transpose(3, 2, 0, 1))

    sd = {}
    for name, v in tf_params.items():
        m = re.fullmatch(r"mapping/Dense(\d+)/(weight|bias)", name)
        if name == "dlatent_avg":
            sd["mapping.w_avg"] = v
        elif name == "mapping/LabelEmbed/weight":
            sd["mapping.embed.weight"] = v.T
        elif name == "mapping/LabelEmbed/bias":
            sd["mapping.embed.bias"] = v
        elif m:
            i, kind = m.groups()
            sd[f"mapping.fc{i}.{kind}"] = v.T if kind == "weight" else v
        elif name == "synthesis/4x4/Const/const":
            sd["synthesis.b4.const"] = v[0]
        elif (m := re.fullmatch(r"synthesis/noise(\d+)", name)):
            k = int(m.group(1))
            if k == 0:
                sd["synthesis.b4.conv1.noise_const"] = v[0, 0]
            else:
                # conv0 at res r carries noise index 2·log2(r)−5 (odd),
                # conv1 carries 2·log2(r)−4 (even) — legacy.py:231,243.
                r = 2 ** ((k + 5) // 2) if k % 2 else 2 ** ((k + 4) // 2)
                conv = "conv0" if k % 2 else "conv1"
                sd[f"synthesis.b{r}.{conv}.noise_const"] = v[0, 0]
        elif (m := re.fullmatch(
                r"synthesis/(\d+)x\1/(Conv|Conv0_up|Conv1|ToRGB|Skip)/(\w+)",
                name)):
            r, op, leaf = m.groups()
            tgt = {"Conv": "conv1", "Conv0_up": "conv0", "Conv1": "conv1",
                   "ToRGB": "torgb", "Skip": "skip"}[op]
            key = f"synthesis.b{r}.{tgt}"
            if leaf == "weight":
                sd[f"{key}.weight"] = (
                    up_w(v) if op in ("Conv0_up", "Skip") else _conv_w(v)
                )
            elif leaf == "bias":
                sd[f"{key}.bias"] = v
            elif leaf == "noise_strength":
                sd[f"{key}.noise_strength"] = v
            elif leaf == "mod_weight":
                sd[f"{key}.affine.weight"] = v.T
            elif leaf == "mod_bias":
                sd[f"{key}.affine.bias"] = v + 1
            else:
                raise KeyError(name)
        else:
            raise KeyError(f"unrecognized TF generator variable {name!r}")
    return sd, kwargs


def convert_tf_discriminator(tf_D):
    """TF StyleGAN2(-ADA) discriminator stub → (upstream-name state dict of
    numpy arrays, init kwargs); as ``legacy.py:269-371``."""
    if getattr(tf_D, "version", 0) < 4:
        raise ValueError("TensorFlow pickle version too low")

    def spec(take):
        kwargs = dict(
            c_dim=take("label_size", 0),
            img_resolution=take("resolution", 1024),
            img_channels=take("num_channels", 3),
            architecture=take("architecture", "resnet"),
            channel_base=take("fmap_base", 16384) * 2,
            channel_max=take("fmap_max", 512),
            num_fp16_res=take("num_fp16_res", 0),
            conv_clamp=take("conv_clamp"),
            cmap_dim=take("mapping_fmaps"),
            block_kwargs=dict(
                activation=take("nonlinearity", "lrelu"),
                resample_filter=take("resample_kernel", [1, 3, 3, 1]),
                freeze_layers=take("freeze_layers", 0),
            ),
            mapping_kwargs=dict(
                num_layers=take("mapping_layers", 0),
                lr_multiplier=take("mapping_lrmul", 0.1),
            ),
            epilogue_kwargs=dict(
                mbstd_group_size=take("mbstd_group_size"),
                mbstd_num_channels=take("mbstd_num_features", 1),
            ),
        )
        take("structure")
        return kwargs

    kwargs = _tf_kwargs(tf_D, spec)
    tf_params = _collect_tf_params(tf_D)
    for name in list(tf_params):
        m = re.fullmatch(r"FromRGB_lod(\d+)/(.*)", name)
        if m:
            r = kwargs["img_resolution"] // (2 ** int(m.group(1)))
            tf_params[f"{r}x{r}/FromRGB/{m.group(2)}"] = tf_params.pop(name)
            kwargs["architecture"] = "orig"

    sd = {}
    for name, v in tf_params.items():
        if (m := re.fullmatch(r"(\d+)x\1/FromRGB/(weight|bias)", name)):
            r, kind = m.groups()
            sd[f"b{r}.fromrgb.{kind}"] = _conv_w(v) if kind == "weight" else v
        elif (m := re.fullmatch(r"(\d+)x\1/(Conv0|Conv1_down|Skip)/(\w+)",
                                name)) and m.group(1) != "4":
            r, op, leaf = m.groups()
            tgt = {"Conv0": "conv0", "Conv1_down": "conv1", "Skip": "skip"}[op]
            sd[f"b{r}.{tgt}.{leaf}"] = _conv_w(v) if leaf == "weight" else v
        elif name == "LabelEmbed/weight":
            sd["mapping.embed.weight"] = v.T
        elif name == "LabelEmbed/bias":
            sd["mapping.embed.bias"] = v
        elif (m := re.fullmatch(r"Mapping(\d+)/(weight|bias)", name)):
            i, kind = m.groups()
            sd[f"mapping.fc{i}.{kind}"] = v.T if kind == "weight" else v
        elif (m := re.fullmatch(r"4x4/Conv/(weight|bias)", name)):
            kind = m.group(1)
            sd[f"b4.conv.{kind}"] = _conv_w(v) if kind == "weight" else v
        elif (m := re.fullmatch(r"4x4/Dense0/(weight|bias)", name)):
            kind = m.group(1)
            sd[f"b4.fc.{kind}"] = v.T if kind == "weight" else v
        elif (m := re.fullmatch(r"Output/(weight|bias)", name)):
            kind = m.group(1)
            sd[f"b4.out.{kind}"] = v.T if kind == "weight" else v
        else:
            raise KeyError(f"unrecognized TF discriminator variable {name!r}")
    return sd, kwargs


def load_network_pkl(path: str):
    """Load a reference network-snapshot pickle and convert G, D and G_ema.

    Both snapshot dialects (ref ``legacy.py:27-74``):

    - **Legacy TF pickles** (a 3-tuple of ``dnnlib.tflib.network.Network``):
      read with the stub unpickler, no TensorFlow, and converted by the TF
      name and layout maps above.
    - **Torch snapshots** (a dict of modules): ``pickle.load`` (upstream's
      persistence pickles need its ``torch_utils`` importable), then each
      module's ``state_dict()`` through ``convert_state_dict``; the init
      kwargs are the module's ``init_kwargs`` where it has them.

    Returns a dict with whatever of ``G``, ``D``, ``G_ema`` is present, as
    ``(state_dict, init_kwargs)`` pairs, the state dicts of CPU tensors.
    """
    # Torch snapshots name classes the stub unpickler cannot resolve: any
    # failure here means "not a legacy TF pickle".
    try:
        with open(path, "rb") as f:
            data = _StubUnpickler(f).load()
    except Exception:
        data = None
    if (
        isinstance(data, tuple)
        and len(data) == 3
        and all(isinstance(n, _TFNetworkStub) for n in data)
    ):
        out = {}
        for name, net, conv in (("G", data[0], convert_tf_generator),
                                ("D", data[1], convert_tf_discriminator),
                                ("G_ema", data[2], convert_tf_generator)):
            sd, kwargs = conv(net)
            out[name] = (convert_state_dict(sd), kwargs)
        return out

    with open(path, "rb") as f:
        data = pickle.load(f)
    out = {}
    for name in ("G", "D", "G_ema"):
        module = data.get(name)
        if module is None:
            continue
        out[name] = (convert_state_dict(module.state_dict()),
                     dict(getattr(module, "init_kwargs", {})))
    return out
