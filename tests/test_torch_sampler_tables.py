"""The fast samplers' schedule tables and the DDIM step of the port
(``models/schedules.py``) against the JAX package, on the CPU.

The reference builds its timestep tables in f32 before converting to
integers, where one ulp moves a timestep. Held here:

* DDIM's ``uniform`` and ``quad`` timesteps, DPM-Solver++'s and the
  Karras grid's integer-equal to JAX's for every S from 2 to 200 at
  T = 1000 (the configs' linear schedule), and for a spread of S at other
  T and under the cosine schedule; their float buffers within 1e-6
  relative on one schedule;
* the S=30 length quirk of uniform DDIM, the respaced (strided) schedule
  and its clipped log-variance, and ``ddim_step`` at η = 0 and η > 0.

The JAX tables of all S are computed in one compiled module per table,
as the reference's jitted samplers compute them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_universal_tpu.models import DDIM as JaxDDIM
from diffusion_model_universal_tpu.models import schedules as js
from diffusion_model_universal_torch.models import DDIM
from diffusion_model_universal_torch.models import schedules as ts

ALL_S = range(2, 201)
SPREAD_S = (2, 3, 7, 11, 18, 20, 30, 49, 50, 51, 99, 100, 101, 162, 200)
SHAPE = (2, 8, 8, 3)


def _schedules(schedule_type="linear", T=1000):
    """The JAX schedule, and the port's NoiseSchedule holding the same
    arrays: the tables' arithmetic is then held at 1e-6 relative (the two
    packages' f32 cumprods differ by up to 3e-7 absolute on their own)."""
    jsch = js.make_noise_schedule(1e-4, 2e-2, T, schedule_type)
    return jsch, ts.NoiseSchedule(**{
        k: torch.from_numpy(np.array(v)) for k, v in vars(jsch).items()})


def _jax_tables(make, jsch, steps):
    return jax.jit(lambda s: [make(s, S) for S in steps])(jsch)


@pytest.mark.parametrize("T,steps", [(1000, ALL_S), (10, SPREAD_S),
                                     (100, SPREAD_S), (999, SPREAD_S),
                                     (1001, SPREAD_S), (4000, SPREAD_S)])
def test_ddim_timesteps_integer_equal(T, steps):
    for method in ("uniform", "quad"):
        want = jax.jit(lambda: [js.ddim_timesteps(T, S, method)
                                for S in steps if S <= T])()
        got = [ts.ddim_timesteps(T, S, method) for S in steps if S <= T]
        for S, w, g in zip(steps, want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{method} T={T} S={S}")


def test_uniform_ddim_keeps_the_reference_length_quirk():
    """S=30 at T=1000: arange(0, 1000, 33) has 31 entries; the sampler
    visits positions 29..0 only."""
    assert len(ts.ddim_timesteps(1000, 30)) == 31
    jm = JaxDDIM({"num_timesteps": 1000, "ddim_sampling_steps": 30,
                  "model_channels": 32})
    m = DDIM({"num_timesteps": 1000, "ddim_sampling_steps": 30,
              "model_channels": 8}, device="cpu")
    assert m.ddim_sampling_steps == jm.ddim_sampling_steps == 30
    assert len(m.ddim_params.timesteps) == 31
    np.testing.assert_array_equal(m.ddim_params.timesteps.numpy(),
                                  np.asarray(jm.ddim_params.timesteps))
    for name in ("alphas", "alphas_prev", "sigmas",
                 "sqrt_one_minus_alphas"):   # each model's own schedule
        np.testing.assert_allclose(getattr(m.ddim_params, name).numpy(),
                                   np.asarray(getattr(jm.ddim_params, name)),
                                   rtol=1e-5, atol=0)
    # S > T is clamped to T (the reference divides by zero there).
    assert DDIM({"num_timesteps": 10, "ddim_sampling_steps": 50,
                 "model_channels": 8}, device="cpu").ddim_sampling_steps == 10


@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_params_match_jax(quad, eta):
    jsch, tsch = _schedules()
    method = "quad" if quad else "uniform"
    for S in (2, 30, 50, 200):
        jp = js.make_ddim_params(jsch, S, method, eta)
        tp = ts.make_ddim_params(tsch, S, method, eta)
        np.testing.assert_array_equal(tp.timesteps.numpy(),
                                      np.asarray(jp.timesteps))
        for name in ("alphas", "alphas_prev", "sigmas",
                     "sqrt_one_minus_alphas"):
            np.testing.assert_allclose(getattr(tp, name).numpy(),
                                       np.asarray(getattr(jp, name)),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("schedule_type,steps", [("linear", ALL_S),
                                                 ("cosine", SPREAD_S)])
def test_dpm_solver_table_matches_jax(schedule_type, steps):
    jsch, tsch = _schedules(schedule_type)
    for S, jp in zip(steps, _jax_tables(js.make_dpm_solver_params, jsch,
                                        steps)):
        tp = ts.make_dpm_solver_params(tsch, S)
        np.testing.assert_array_equal(tp.timesteps.numpy(),
                                      np.asarray(jp.timesteps),
                                      err_msg=f"S={S}")
        for name in ("alpha", "sigma", "lam"):
            np.testing.assert_allclose(getattr(tp, name).numpy(),
                                       np.asarray(getattr(jp, name)),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule_type,steps", [("linear", ALL_S),
                                                 ("cosine", SPREAD_S)])
def test_karras_table_matches_jax(schedule_type, steps):
    jsch, tsch = _schedules(schedule_type)
    for S, jk in zip(steps, _jax_tables(js.make_karras_heun_params, jsch,
                                        steps)):
        tk = ts.make_karras_heun_params(tsch, S)
        np.testing.assert_array_equal(tk.timesteps.numpy(),
                                      np.asarray(jk.timesteps),
                                      err_msg=f"S={S}")
        for name in ("alpha", "sigma_hat"):
            np.testing.assert_allclose(getattr(tk, name).numpy(),
                                       np.asarray(getattr(jk, name)),
                                       rtol=1e-6)


def test_tables_equal_those_the_jax_samplers_use():
    """The reference's samplers are jitted, their schedule a constant: the
    port's tables equal those at the samplers' default S and at edge S.
    Called one S at a time outside jit, JAX's own Karras table differs
    from its compiled one at S=162 (by one timestep); elsewhere they
    agree."""
    jsch, tsch = _schedules()
    for S in (2, 18, 20, 100, 162):
        for make in ("make_dpm_solver_params", "make_karras_heun_params"):
            compiled = jax.jit(lambda: getattr(js, make)(jsch, S))()
            got = getattr(ts, make)(tsch, S).timesteps.numpy()
            np.testing.assert_array_equal(got, np.asarray(compiled.timesteps))
            if S != 162:
                np.testing.assert_array_equal(
                    got, np.asarray(getattr(js, make)(jsch, S).timesteps))
        np.testing.assert_array_equal(
            ts.ddim_timesteps(1000, S, "quad").numpy(),
            np.asarray(js.ddim_timesteps(1000, S, "quad")))


def test_respaced_schedule_and_clipped_log_variance():
    jsch, tsch = _schedules()
    for S in (2, 7, 100, 1000):
        jt, tt = js.respace_timesteps(1000, S), ts.respace_timesteps(1000, S)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jsub, tsub = js.respaced_schedule(jsch, jt), ts.respaced_schedule(
            tsch, tt)
        np.testing.assert_allclose(tsub.betas.numpy(),
                                   np.asarray(jsub.betas), rtol=1e-6)
        # The coarse schedule's own cumprod: XLA's and torch's f32 products
        # differ in their order, which 1−ᾱ magnifies near t = 0.
        for name in ("alphas_cumprod", "posterior_variance"):
            np.testing.assert_allclose(getattr(tsub, name).numpy(),
                                       np.asarray(getattr(jsub, name)),
                                       rtol=2e-4)
        np.testing.assert_allclose(
            ts.posterior_log_variance_clipped(tsub).numpy(),
            np.asarray(js.posterior_log_variance_clipped(jsub)), atol=2e-4)
    with pytest.raises(ValueError, match=r"num_steps must be in \[2, 1000\]"):
        ts.respace_timesteps(1000, 1)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_matches_jax(eta):
    jsch, tsch = _schedules()
    jp = js.make_ddim_params(jsch, 50, "uniform", eta)
    tp = ts.make_ddim_params(tsch, 50, "uniform", eta)
    rng = np.random.default_rng(0)
    x, e, n = (rng.standard_normal(SHAPE).astype(np.float32) * s
               for s in (1.0, 1.0, 2.0))
    for i in (0, 1, 25, 49):
        want = js.ddim_step(jp, jnp.asarray(x), i, jnp.asarray(e),
                            jnp.asarray(n), eta)
        got = ts.ddim_step(tp, torch.from_numpy(x), i, torch.from_numpy(e),
                           torch.from_numpy(n), eta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)
