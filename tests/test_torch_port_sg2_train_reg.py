"""The port's StyleGAN2 reg step (path length and R1 on) against the JAX
package, on the CPU; the helpers, the setup and what is compared are those
of ``test_torch_port_sg2_train.py`` (a file of its own so that the two JAX
compiles run in parallel under xdist)."""

from test_torch_port_sg2_train import _one_torch_thread, check_step, setup  # noqa: F401


def test_sg2_reg_step_matches_jax(setup):  # noqa: F811
    check_step(setup, do_reg=True, ada=False)
