"""What a run loads: neither JAX nor the JAX package (top-level names
compared whole), and a reference that imports nothing of the port; and the
frozen reference computes what the port computes where both run their
plain paths (the CPU, float32)."""

import json
import subprocess
import sys

import pytest
import torch

import harness
from conftest import toy_ctx

PB = str(harness.PB)
ROOT = str(harness.ROOT)


def _in_fresh_process(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    """Every module of the harness, its drivers and readers, and a whole toy
    run of each driver on the CPU: ``sys.modules`` then holds no module
    whose top-level name is jax, jaxlib, flax or ic_gan_tpu."""
    code = f"""
import sys, json
sys.path[:0] = [{PB!r}, {ROOT!r}]
sys.path.insert(0, {PB + '/tests'!r})
import torch
torch.set_num_threads(2)
import harness, run, calibrate, tracing, weights, readers, traincheck, kernels, peaks
from conftest import toy_ctx
b = harness.load_benchmark()
for m in b["end_to_end"] + b["per_layer"]:
    harness.reader(m["name"])
for w in b["workloads"]:
    ctx = toy_ctx(w["name"], seconds=0.05)
    ctx["limits"] = {{k: float("inf") for k in ctx["limits"]}}
    harness.driver(ctx["mix"]["driver"]).run(ctx)
assert "ic_gan_tpu_torch" in sys.modules
print(json.dumps(harness.forbidden_loaded()))
"""
    assert _in_fresh_process(code) == []


def test_the_reference_imports_nothing_of_the_port():
    code = f"""
import sys, json
sys.path[:0] = [{PB!r}]
import reference
from reference.icgan_ref.models import biggan, stylegan2
from reference.icgan_ref.train import step, stylegan2_step
from reference.icgan_ref.data import ada
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"ic_gan_tpu_torch", "ic_gan_tpu", "jax", "jaxlib", "flax"}})))
"""
    assert _in_fresh_process(code) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ic_gan_tpu_torch_x", sys)
    assert "ic_gan_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax"]


@pytest.mark.parametrize("net", ["Generator", "Discriminator"])
def test_frozen_biggan_matches_the_port_on_the_cpu(net):
    """Same weights from the seed, float32, plain paths: the frozen copy
    gives the port's outputs."""
    import importlib

    from weights import make_state, materialize, shapes_of

    ctx = toy_ctx("icgan_biggan_res256.sample_b128")
    outs = []
    for pkg in ("ic_gan_tpu_torch", "reference.icgan_ref"):
        mod = importlib.import_module(f"{pkg}.models.biggan")
        cfg = mod.BigGANConfig(**ctx["cfg"]["model"], dtype=torch.float32)
        m = getattr(mod, net)(cfg, device="meta")
        m = materialize(m, make_state(shapes_of(m), ctx["cfg"]["init"], 7, "cpu"), "cpu")
        gen = torch.Generator().manual_seed(3)
        x = (torch.randn((4, cfg.effective_dim_z), generator=gen) if net == "Generator"
             else torch.rand((4, 3, 32, 32), generator=gen) * 2 - 1)
        feats = torch.randn((4, cfg.instance_sz), generator=gen)
        with torch.no_grad():
            outs.append(m.eval()(x, None, feats))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_frozen_stylegan2_matches_the_port_on_the_cpu():
    import importlib

    from weights import make_state, materialize, shapes_of

    ctx = toy_ctx("icgan_sg2ada_res256.train_mb16")
    model = dict(ctx["cfg"]["model"], num_fp16_res=0)
    outs = []
    for pkg in ("ic_gan_tpu_torch", "reference.icgan_ref"):
        sg2 = importlib.import_module(f"{pkg}.models.stylegan2")
        cfg = sg2.StyleGAN2Config(**model)
        g = sg2.Generator(cfg, device="meta")
        g = materialize(g, make_state(shapes_of(g), ctx["cfg"]["init"], 9, "cpu"), "cpu")
        gen = torch.Generator().manual_seed(4)
        z, h = torch.randn((2, cfg.z_dim), generator=gen), torch.randn((2, cfg.h_dim),
                                                                        generator=gen)
        with torch.no_grad():
            outs.append(g(z, None, h, noise_mode="const"))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
