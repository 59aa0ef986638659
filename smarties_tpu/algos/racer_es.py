"""RACER/V-RACER with CMA-ES optimization (ESpopSize > 1).

JAX re-expression of the reference's derivative-free RACER path
(VRACER_CMA.json recipe): Learner_approximator::spawnTrainTasks loops the
Train kernel over every population member computing per-member rho / A_RET
/ DKL (RACER_train.cpp:62-66), RACER::prepareCMALoss mixes them into
per-member costs

    cost(w) = alpha * (costAdv + costDkl) + (1 - alpha) * costVal
    costAdv = -beta * clip(rho_w) * avgAdv     (minus: minimize)
    costVal =  beta * (min(1, avgRho) * clipAdv)^2
    costDkl = (1 - beta) * dkl_w

(RACER_common.cpp:35-68, with avg over members and far-policy replacement
of adv by avgAdv), and CMA_Optimizer::apply_update performs the
rank-weighted diagonal-covariance update (CMA_Optimizer.cpp:66-140).

Population forwards are one vmap over stacked member weights; acting uses
member 0 (the CMA mean), matching the reference's sample-0 load.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from smarties_tpu.algos.base import (default_metrics, gather_minibatch,
                                     post_step_processing, write_back)
from smarties_tpu.algos.cma import pop_weights
from smarties_tpu.algos.vracer import VRacer
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import apply_net
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.ops import discrete_policy as dpol
from smarties_tpu.ops.value_scale import scale_net2v
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32


class ESOptState(NamedTuple):
    diag_cov: jnp.ndarray
    path_cov: jnp.ndarray
    noise: jnp.ndarray       # [P, n]
    step: jnp.ndarray


class RacerES(VRacer):
    """params == {"pop": [P, n] flat weight vectors} (member 0 = mean)."""

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters,
                 adv_kind: str | None = None):
        super().__init__(mdp, cfg, adv_kind)
        assert cfg.ESpopSize > 1, "RacerES requires ESpopSize > 1"
        self.P = cfg.ESpopSize
        w = jnp.asarray(pop_weights(self.P))
        self.w_pop = w
        w_pos = jnp.maximum(w, 0.0)
        self.mu_eff = float(jnp.sum(w_pos) ** 2 / jnp.sum(w_pos * w_pos))
        self.sum_w = float(jnp.sum(w))

    # ------------------------------------------------------------------
    def init(self, key):
        from smarties_tpu.models.net import init_params
        k1, k2 = jax.random.split(key)
        p0 = init_params(k1, self.spec)
        flat, self.unravel = ravel_pytree(p0)
        n = flat.shape[0]
        params = {"pop": jnp.tile(flat[None], (self.P, 1))}
        opt = ESOptState(diag_cov=jnp.ones((n,), F32),
                         path_cov=jnp.zeros((n,), F32),
                         noise=jnp.zeros((self.P, n), F32),
                         step=jnp.int32(0))
        params["pop"], opt = self._resample(params["pop"][0], opt, k2)
        return params, opt

    def _resample(self, mean, opt: ESOptState, key):
        """Mirrored population sampling (CMA_Optimizer.cpp:158-178)."""
        n = mean.shape[0]
        eta = anneal_rate(self.cfg.learnrate, opt.step.astype(F32),
                          self.cfg.epsAnneal)
        z = jax.random.normal(key, (self.P, n), F32)
        y = z * opt.diag_cov[None, :]
        idx = jnp.arange(self.P)
        mirror = (idx % 2 == 0) & (idx > 0)
        y = jnp.where(mirror[:, None], -jnp.roll(y, 1, axis=0), y)
        y = y.at[0].set(0.0)
        return mean[None, :] + eta * y, opt._replace(noise=y)

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        base_act = super().make_act_fn(train)

        def act(params, obs_std, key, rnn=()):
            mean_params = self.unravel(params["pop"][0])
            return base_act(mean_params, obs_std, key, rnn)

        return act

    def init_rnn(self, n_envs: int):
        return super().init_rnn(n_envs)

    # ------------------------------------------------------------------
    def _member_eval(self, flat_w, mb):
        """Per-member forward: (rho, a_ret_minus_aval parts, dkl)."""
        p = self.unravel(flat_w)
        out, _ = apply_net(p, self.spec, mb.s_t)
        v_raw, adv_out, pol, sraw = self._split_out(out)
        v_val = scale_net2v(v_raw)
        if self.discrete:
            opt_a = mb.action[..., 0].astype(jnp.int32)
            _, _, probs = dpol.probs_of(pol)
            rho = dpol.imp_weight(opt_a, probs, mb.mu)
            dkl = dpol.kl_mu_pi(mb.mu, probs)
            a_val = self._advantage(adv_out, opt_a, pol, probs=probs)
        else:
            sigma = cp.sigma_of(sraw)
            rho = cp.imp_weight(mb.action, pol, sigma, mb.mu, self.bounded)
            dkl = cp.kl_div(mb.mu, pol, sigma)
            a_val = self._advantage(adv_out, mb.action, pol, sigma=sigma)
        a_ret = mb.qret - v_val
        return rho, a_ret, dkl, a_val, v_val

    # inherits VRacer.presample, but this step's key chain differs
    # (split(key) -> (k_samp, k_res)) and population forwards dominate
    # its cost anyway: keep in-body sampling
    presample = False

    def train_step(self, params, opt_state: ESOptState, rs: rb.ReplayState,
                   key, axis_name=None):
        cfg = self.cfg
        B = cfg.batchSize
        k_samp, k_res = jax.random.split(key)
        ep, t = rb.sample(k_samp, rs, B, cfg.dataSamplingAlgo)
        mb = gather_minibatch(rs, ep, t,
                              n_appended=self.mdp.n_appended_obs)

        rhos, advs, dkls, avals, vvals = jax.vmap(
            lambda w: self._member_eval(w, mb))(params["pop"])  # [P, B]

        beta, alpha = rs.beta, rs.alpha
        cmax, cinv = rs.cmax_ret, rs.cinv_ret
        avg_rho = jnp.mean(rhos, axis=0)            # [B]
        avg_adv = jnp.mean(advs, axis=0)
        is_far = (rhos >= cmax) | (rhos <= cinv)    # [P, B]
        clip_rho = jnp.clip(rhos, cinv, cmax)
        clip_adv = jnp.where(is_far, avg_adv[None, :], advs)
        critic_err = jnp.minimum(1.0, avg_rho)[None, :] * clip_adv
        cost_adv = -beta * clip_rho * avg_adv[None, :]
        cost_val = beta * critic_err ** 2
        cost_dkl = (1 - beta) * dkls
        losses = jnp.sum(alpha * (cost_adv + cost_dkl)
                         + (1 - alpha) * cost_val, axis=1)   # [P]
        if axis_name is not None:
            losses = jax.lax.psum(losses, axis_name)

        # ---- CMA update (CMA_Optimizer::apply_update) ----
        c1cov, c_sig = 1e-5, 1e-3
        order = jnp.argsort(losses)
        x_sorted = params["pop"][order]
        y_sorted = opt_state.noise[order]
        w = self.w_pop
        w_pos = jnp.maximum(w, 0.0)
        new_mean = jnp.sum(w_pos[:, None] * x_sorted, axis=0)
        avg_n = jnp.sum(w_pos[:, None] * y_sorted, axis=0)
        mom_n = jnp.sum(w[:, None] * y_sorted * y_sorted, axis=0)
        alpha_c = 1 - c1cov - self.sum_w * self.mu_eff * c1cov
        upd_sig = np.sqrt(c_sig * (2 - c_sig) * self.mu_eff)
        path = (1 - c_sig) * opt_state.path_cov + upd_sig * avg_n
        s2 = (alpha_c * opt_state.diag_cov ** 2 + c1cov * path ** 2
              + self.mu_eff * c1cov * mom_n)
        sig = jnp.clip(jnp.sqrt(jnp.maximum(s2, 0.0)), 0.01, 10.0)
        new_opt = ESOptState(diag_cov=sig, path_cov=path,
                             noise=opt_state.noise,
                             step=opt_state.step + 1)
        new_pop, new_opt = self._resample(new_mean, new_opt, k_res)
        new_params = {"pop": new_pop}

        # write-backs with the MEAN member's statistics
        rs = write_back(rs, mb, rhos[0], dkls[0], advs[0] - avals[0],
                        vvals[0], avals[0])
        rs, frac_off = post_step_processing(rs, cfg, new_opt.step,
                                            advs[0] - avals[0], axis_name)
        metrics = default_metrics(dkls[0], rhos[0],
                                  rb.is_far_policy(rhos[0], cmax, cinv),
                                  frac_off, rs.beta, advs[0] - avals[0],
                                  vvals[0], axis_name)
        return new_params, new_opt, rs, metrics
