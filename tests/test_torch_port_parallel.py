"""Data parallelism of the port (``ic_gan_tpu_torch/parallel``) against the
JAX package's global-batch semantics.

The helpers (``local_batch_size``, the mesh's clamp, ``stats``) against
``ic_gan_tpu.parallel`` on the same numbers; then one launch of two
processes over gloo on the CPU (``torch_port_parallel_worker.py``, no JAX
there), rendezvous through a file in ``tmp_path``.  Each rank runs the
three legs of ``__graft_entry__.dryrun_multichip`` in float64 at its
geometry, plus a StyleGAN2 step with the ADA pipe, and the same steps on
one rank over the global batch; ``dryrun_multichip``'s contract
(``_assert_equiv``: raw gradients max|Δ| < 1e-5, scalars within 1e-5 +
1e-5·|ref|) holds on both ranks.  The launch also runs the sharded
Inception evaluator and sampler, the collector, a one-step ``Trainer.run``,
the mesh's clamp and ``replicated``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ic_gan_tpu.parallel import mesh as jmesh
from ic_gan_tpu.parallel import stats as jstats
from ic_gan_tpu_torch.parallel import mesh as tmesh
from ic_gan_tpu_torch.parallel import stats as tstats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_parallel_worker.py")
WORLD = 2
LAUNCH_TIMEOUT_S = 240
LEGS = ("biggan", "deep", "sg2", "sg2_ada")


def test_local_batch_size_and_mesh_clamp_match_jax():
    for b in (1, 2, 6, 64):
        assert tmesh.local_batch_size(b) == jmesh.local_batch_size(b)
    n = len(jax.devices())
    assert n > 2
    for b in range(1, 3 * n):
        assert tmesh.data_ranks(n, batch_size=b) == jmesh.make_mesh(batch_size=b).shape["data"]
    for n_data in (1, 2, n):
        assert tmesh.data_ranks(n, n_data) == jmesh.make_mesh(n_data).shape["data"]
    with pytest.raises(ValueError):
        tmesh.data_ranks(n, n + 1)
    m = tmesh.make_mesh(device="cpu")      # no process group: one rank
    assert (m.group, m.world, m.rank, m.holds_share) == (None, 1, 0, True)
    assert tmesh.is_main_process() and tmesh.process_count() == 1


def test_stats_report_and_collector_match_jax():
    rng = np.random.default_rng(0)
    steps = [(rng.standard_normal(5), rng.standard_normal((2, 3))) for _ in range(3)]
    jc, tc = jstats.Collector("loss/.*"), tstats.Collector("loss/.*")
    for a, b in steps:
        js = jstats.report(jstats.report({}, "loss/a", a), "loss/a", b)
        ts = tstats.report(tstats.report({}, "loss/a", torch.from_numpy(a)), "loss/a",
                           torch.from_numpy(b))
        js, ts = jstats.report(js, "other", a), tstats.report(ts, "other", torch.from_numpy(a))
        np.testing.assert_allclose(ts["loss/a"].numpy(), np.asarray(js["loss/a"]), rtol=1e-6)
        jc.update(js)
        tc.update(ts)
    want, got = jc.as_dict(), tc.as_dict()
    assert set(got) == set(want) == {"loss/a"}
    for k in ("num", "mean", "std"):
        np.testing.assert_allclose(got["loss/a"][k], want["loss/a"][k], rtol=1e-6)
    assert np.isnan(tc.mean("absent")) and tc.num("absent") == 0.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results (one launch for the file)."""
    out = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    logs = [open(out / f"log{r}.txt", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD),
                               f"file://{out / 'rendezvous'}", str(out)],
                              cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=LAUNCH_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = "\n".join((out / f"log{r}.txt").read_text()[-3000:] for r in range(WORLD))
    assert codes == [0] * WORLD, tails
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("leg", LEGS)
def test_two_gloo_ranks_meet_the_dryrun_contract(ranks, leg):
    """n ranks against one rank on the global batch, float64: raw gradients
    max|Δ| < 1e-5 and every scalar within 1e-5 + 1e-5·|ref|, on both ranks;
    BN statistics and the w average as one rank's; the gradients are real."""
    for res in ranks:
        ref, dp = res[leg]["ref"], res[leg]["dp"]
        for which in ("g_grads", "d_grads"):
            assert set(dp[which]) == set(ref[which])
            worst = max(np.abs(dp[which][k] - ref[which][k]).max() for k in ref[which])
            assert worst < 1e-5, (leg, which, worst)
            assert max(np.abs(v).max() for v in ref[which].values()) > 1e-3
        scalars = [k for k in ref if k not in ("g_grads", "d_grads")]
        assert set(scalars) == {k for k in dp if k not in ("g_grads", "d_grads")}
        for k in scalars:
            a, b = ref[k], dp[k]
            assert np.isfinite(a) and abs(a - b) <= 1e-5 + 1e-5 * abs(a), (leg, k, a, b)
        for got, want in zip(res[leg]["dp_state"], res[leg]["ref_state"]):
            for k in got:
                if k.endswith(("stored_mean", "stored_var", "w_avg")):
                    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                               atol=1e-12, err_msg=f"{leg} {k}")
    if leg in ("sg2", "sg2_ada"):
        assert ranks[0][leg]["ref"]["ada_sign_sum"] != 0.0
    if leg == "sg2":
        assert ranks[0][leg]["ref"]["pl_mean"] != 0.0 and "r1_penalty" in ranks[0][leg]["ref"]


def test_two_ranks_hold_identical_state(ranks):
    """After each step, every parameter and buffer (G, D, the EMA copy)
    equal on both ranks, bit for bit; the launch imported no JAX."""
    for leg in LEGS + ("trainer",):
        states = [r[leg]["dp_state"] if leg != "trainer" else r[leg]["state"] for r in ranks]
        for a, b in zip(*states):
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (leg, k)
    assert not any(r["jax_imported"] for r in ranks)


def test_sharded_eval_and_sampler_match_one_rank(ranks):
    """Three images over two ranks (one row of padding) and five samples in
    batches of four: every rank returns one rank's arrays."""
    ref = ranks[0]["eval"]
    for res in ranks:
        ev = res["eval"]
        assert ev["pool"].shape == (3, 2048) and ev["logits"].shape == (3, 1000)
        np.testing.assert_allclose(ev["pool"], ref["ref_pool"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(ev["logits"], ref["ref_logits"], rtol=0, atol=1e-5)
        assert ev["images"].shape == (5, 32, 32, 3)
        np.testing.assert_allclose(ev["images"], ev["ref_images"], rtol=0, atol=1e-12)


def test_trainer_run_writes_on_rank_0_only(ranks):
    """One data-parallel step of ``Trainer.run``: rank 0 writes the
    checkpoint, its copy, the logs and the sheet; rank 1 writes nothing."""
    files0, files1 = (r["trainer"]["files"] for r in ranks)
    assert {"w/dp/state.pt", "w/dp_copy0/state.pt", "l/dp/dp_log.jsonl"} <= set(files0)
    assert files1 == []
    assert [r["trainer"]["itr"] for r in ranks] == [1, 1]


def test_trainer_eval_on_rank_0_decides_for_every_rank(ranks):
    """Only rank 0 evaluates; its IS and FID reach every rank, so an eval
    that would score the ranks differently still stops both at rank 0's
    early stop (epoch 2, patience 1) with the same history and state."""
    r0, r1 = (r["trainer_stop"] for r in ranks)
    assert r0["eval_calls"] == [1, 2] and r1["eval_calls"] == []
    for r in (r0, r1):
        assert (r["itr"], r["best_IS"], r["no_improvement"]) == (2, 1.0, 1)
    for a, b in zip(r0["state"], r1["state"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_mesh_helpers_and_collector_across_ranks(ranks):
    """``make_mesh``'s clamp (batch 3 over two ranks: rank 1 idle),
    ``local_batch_size``, ``replicated`` from rank 0, and the collector's
    sum over ranks against JAX's collector on the ranks' values together."""
    assert [r["clamped"] for r in ranks] == [(1, 0), (1, -1)]
    assert [(r["world"], r["rank"]) for r in ranks] == [(2, 0), (2, 1)]
    for r in ranks:
        assert r["local_batch"] == 3 and "not divisible by 2" in r["local_batch_5"]
        assert r["replicated"] == (0.0, [1.0, 1.0])
    jc = jstats.Collector("loss.*")
    for rank in range(WORLD):
        jc.update(jstats.report({}, "loss/a", np.arange(3.0) + 10 * rank))
    for r in ranks:
        assert set(r["collector"]) == {"loss/a"}
        for k in ("num", "mean", "std"):
            np.testing.assert_allclose(r["collector"]["loss/a"][k], jc.as_dict()["loss/a"][k],
                                       rtol=1e-6)
