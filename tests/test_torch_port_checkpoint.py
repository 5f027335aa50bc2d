"""The port's checkpoints (``io/checkpoint.py``), on the CPU.

Round trips of the StyleGAN2-ADA ``SG2TrainState`` and of the BigGAN
``GANTrainState`` at toy sizes, after a real step so that both Adam states
hold moments: every tensor comes back bit for bit, and one more step from
the loaded state equals one from the original, bit for bit.
``find_best_checkpoint`` against the JAX function on the same files.
"""

import json
import os

import numpy as np
import pytest
import torch

from ic_gan_tpu.io import checkpoint as jckpt
from ic_gan_tpu_torch.io import checkpoint as tckpt
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.train import step as tstep
from ic_gan_tpu_torch.train import stylegan2_step as tsg2step
from ic_gan_tpu_torch.train.state import GANTrainState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MB = 4
SG2 = tsg2.StyleGAN2Config(img_resolution=16, z_dim=8, c_dim=0, h_dim=12, w_dim=16,
                           channel_base=512, channel_max=32, num_fp16_res=0,
                           conv_clamp=None, num_mapping_layers=2, mbstd_group_size=2)
SG2_TRAIN = tsg2step.SG2TrainConfig(G_reg_interval=2, D_reg_interval=3)
# The toy geometry of tests/test_torch_port_train.py.
BIGGAN = tbiggan.BigGANConfig(resolution=32, G_ch=16, D_ch=16, G_attn="16", D_attn="16",
                              dim_z=40, shared_dim_feat=32, instance_sz=64)
BIGGAN_TRAIN = tstep.TrainConfig(ema_start=0)


def _sg2_state(seed):
    gen = torch.Generator().manual_seed(seed)
    g = tsg2.Generator(SG2, device="cpu", generator=gen)
    d = tsg2.Discriminator(SG2, device="cpu", generator=gen)
    return tsg2step.SG2TrainState.create(g, d, SG2_TRAIN)


def _sg2_batch():
    rng = np.random.RandomState(0)
    return dict(x=torch.from_numpy(rng.uniform(-1, 1, (MB, 3, 16, 16)).astype(np.float32)),
                h=torch.from_numpy(rng.randn(MB, 12).astype(np.float32)),
                gen_h=torch.from_numpy(rng.randn(MB, 12).astype(np.float32)))


def _sg2_step(state):
    step = tsg2step.make_sg2_train_step(SG2_TRAIN, SG2.z_dim, do_pl=False, do_r1=False)
    return step(state, _sg2_batch(), torch.Generator().manual_seed(5 + state.step))


def _biggan_state(seed):
    gen = torch.Generator().manual_seed(seed)
    g = tbiggan.Generator(BIGGAN, device="cpu", generator=gen)
    d = tbiggan.Discriminator(BIGGAN, device="cpu", generator=gen)
    return GANTrainState.create(g, d, BIGGAN_TRAIN.g_optimizer(), BIGGAN_TRAIN.d_optimizer())


def _biggan_step(state):
    rng = np.random.RandomState(1)
    batch = dict(x=torch.from_numpy(rng.uniform(-1, 1, (1, MB, 3, 32, 32)).astype(np.float32)),
                 feats=torch.from_numpy(rng.randn(1, MB, 64).astype(np.float32)),
                 gen_feats=torch.from_numpy(rng.randn(2, MB, 64).astype(np.float32)))
    step = tstep.make_train_step(BIGGAN_TRAIN, BIGGAN.effective_dim_z)
    return step(state, batch, torch.Generator().manual_seed(7 + state.step))


def _tensors(state):
    """Every tensor and number of a state, by a flat name."""
    out = {}
    for key, v in vars(state).items():
        if isinstance(v, (torch.nn.Module, torch.optim.Optimizer)):
            sd = v.state_dict()
            if isinstance(v, torch.optim.Optimizer):
                sd = {f"{i}.{k}": t for i, s in sd["state"].items() for k, t in s.items()}
            out.update({f"{key}.{k}": t for k, t in sd.items()})
        else:
            out[key] = v
    return out


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k, v in ta.items():
        if torch.is_tensor(v):
            assert v.dtype == tb[k].dtype and v.device == tb[k].device, k
            assert torch.equal(v, tb[k]), k
        else:
            assert v == tb[k], k


CASES = {"sg2": (_sg2_state, _sg2_step), "biggan": (_biggan_state, _biggan_step)}


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_is_bit_identical_and_the_next_step_too(case, tmp_path):
    make, step = CASES[case]
    live, _ = step(make(0))
    if case == "sg2":
        live.ada_p = torch.tensor(0.25)
        live.pl_mean = live.pl_mean + 0.5
    path = tckpt.save_checkpoint(str(tmp_path), "snap", live, config={"kimg": 1.5},
                                 suffix="best0")
    assert sorted(os.listdir(path)) == ["config.json", "state.pt"]
    assert not os.path.exists(path + ".tmp")
    fresh = make(1)                          # other weights, empty optimizers
    loaded, config = tckpt.load_checkpoint(str(tmp_path), "snap", fresh, suffix="best0")
    assert loaded is fresh and config == {"kimg": 1.5}
    _assert_same(loaded, live)
    a, ma = step(live)
    b, mb = step(loaded)
    _assert_same(a, b)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    # Saving again replaces the directory whole.
    tckpt.save_checkpoint(str(tmp_path), "snap", a, suffix="best0")
    assert not os.path.exists(os.path.join(path, "config.json"))


def test_load_refuses_a_state_of_another_structure(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), "snap", _sg2_state(0))
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(str(tmp_path), "snap", _biggan_state(0))


def test_find_best_checkpoint_matches_jax(tmp_path):
    for i, fid in ((0, 12.5), (1, 9.25), (3, 1.0)):   # best3 lies beyond num_best
        os.makedirs(tmp_path / f"exp_best{i}")
        with open(tmp_path / f"exp_best{i}" / "config.json", "w") as f:
            json.dump({"best_FID": fid}, f)
    os.makedirs(tmp_path / "exp_best2")               # no config: skipped
    for num_best in (1, 2, 4):
        got = tckpt.find_best_checkpoint(str(tmp_path), "exp", num_best)
        assert got == jckpt.find_best_checkpoint(str(tmp_path), "exp", num_best)
    assert tckpt.find_best_checkpoint(str(tmp_path), "exp", 4)[1] == 1.0
    assert tckpt.find_best_checkpoint(str(tmp_path), "none") == (None, float("inf"))
