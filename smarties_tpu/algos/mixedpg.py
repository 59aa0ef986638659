"""MixedPG: mixed stochastic + deterministic policy gradient (experimental).

JAX re-expression of the reference MixedPG
(source/smarties/Learners/MixedPG.{h,cpp}): an actor producing
[policy mean, V head, (param) stdev] and a Q-critic with the action as an
extra input; the policy gradient mixes the off-policy stochastic PG with
the deterministic dQ/da gradient, weighted per action-dim by an EMA of
0.2 * std(SPG_i)/rms(DPG_i) (MixedPGstats::update); far-policy samples get
asymmetric critic-error gating (corrections toward the trust region pass);
ReF-ER beta-mixes the KL penalty as usual.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.algos.base import (default_metrics, gather_minibatch,
                                     post_step_processing, write_back_with_next)
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import NetSpec, apply_net, init_params
from smarties_tpu.models.optim import (AdamConfig, AdamState, adam_init,
                                       adam_step)
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32
NN_EPS = float(np.finfo(np.float32).eps)


class MixedPGOptState(NamedTuple):
    adam: AdamState
    dpg_factor: jnp.ndarray   # [nA] adaptive DPG mixing weight
    err_q_factor: jnp.ndarray

    @property
    def step(self):
        return self.adam.step


class MixedPG:
    presample = True   # uniform sampling hoistable out of scan bodies
    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        assert not mdp.is_discrete
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        # actor outputs: [mean(nA), V(1)] + param stdev(nA)
        # (POL({0, nA+1}) in MixedPG.cpp:15)
        self.actor_spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
            n_out=nA + 1, kind="FFNN", act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac,
            n_param_out=nA, param_init=tuple([sig0] * nA))
        self.critic_spec = NetSpec(
            n_in=mdp.dim_net_input + nA, hidden=tuple(cfg.nnLayerSizes),
            n_out=1, kind="FFNN", act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac)
        self.bounded = np.asarray(mdp.bounded_mask)
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        self.returns_mode = ("retrace" if cfg.returnsEstimator
                             in ("default", "retrace")
                             else cfg.returnsEstimator)

    # ------------------------------------------------------------------
    def init(self, key):
        k1, k2 = jax.random.split(key)
        net = {"actor": init_params(k1, self.actor_spec),
               "critic": init_params(k2, self.critic_spec)}
        opt = MixedPGOptState(
            adam=adam_init(net),
            dpg_factor=jnp.zeros((self.mdp.dim_action,), F32),
            err_q_factor=jnp.float32(0.0))
        return net, opt

    def _actor(self, net, x):
        nA = self.mdp.dim_action
        out, _ = apply_net(net["actor"], self.actor_spec, x)
        return out[..., :nA], out[..., nA], out[..., nA + 1:]

    def _critic(self, net, x, a):
        q, _ = apply_net(net["critic"], self.critic_spec,
                         jnp.concatenate([x, a], axis=-1))
        return q[..., 0]

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        bounded = self.bounded
        sample = train and self.cfg.explNoise > 0

        def act(params, obs_std, key, rnn=()):
            mean, v_act, sraw = self._actor(params, obs_std)
            sigma = cp.sigma_of(sraw)
            a = cp.sample(key, mean, sigma, bounded) if sample \
                else cp.eff_mean(mean, bounded)
            mu = cp.mu_vector(mean, sigma, bounded)
            sval = self._critic(params, obs_std, mean)
            qval = self._critic(params, obs_std, a)
            # appendValues((sval+V)/2, qval + V/2 - sval/2)
            # (MixedPG.cpp:78-80)
            v_est = (sval + v_act) / 2
            return a, mu, v_est, qval + v_act / 2 - sval / 2 - v_est, rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: MixedPGOptState,
                   rs: rb.ReplayState, key, axis_name=None, sample_override=None):
        """MixedPG::Train (MixedPG.cpp:12-66) as one XLA program."""
        cfg = self.cfg
        nA = self.mdp.dim_action
        n_shards = (jax.lax.psum(1, axis_name) if axis_name is not None
                    else 1)
        B = cfg.batchSize // n_shards if axis_name is not None \
            else cfg.batchSize
        if axis_name is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        if sample_override is not None:
            ep, t = sample_override   # hoisted pre-sampling (base.py
            # presample_uniform: no RNG primitives in the scan body)
        else:
            k_samp, = jax.random.split(key, 1)
            ep, t = rb.sample(k_samp, rs, B, cfg.dataSamplingAlgo)
        mb = gather_minibatch(rs, ep, t)

        mean, v_act, sraw = self._actor(params, mb.s_t)
        sigma = cp.sigma_of(sraw)
        rho = cp.imp_weight(mb.action, mean, sigma, mb.mu, self.bounded)
        dkl = cp.kl_div(mb.mu, mean, sigma)
        is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
        beta = rs.beta

        sval = self._critic(params, mb.s_t, mean)
        qval = self._critic(params, mb.s_t, mb.action)
        # dQ/da at the policy mean, through the online critic
        dpg = jax.vmap(jax.grad(
            lambda a, x: self._critic(params, x[None], a[None])[0]))(
            mean, mb.s_t)

        a_est = qval - sval
        v_est = (sval + v_act) / 2
        q_ret = mb.qret
        a_ret = q_ret - v_est
        dq = q_ret - qval
        dv = v_act - sval

        # asymmetric far-policy gating (MixedPG.cpp:37-44)
        q_err = jnp.where(is_far, 0.0, rho * dq)
        q_err = jnp.where(is_far & (rho > 1) & (dq < 0),
                          jnp.minimum(rs.cmax_ret, rho) * dq, q_err)
        q_err = jnp.where(is_far & (rho < 1) & (dq > 0),
                          jnp.maximum(rs.cinv_ret, rho) * dq, q_err)
        v_err = jnp.where(is_far, 0.0, dv)
        v_err = jnp.where(is_far & (rho > 1) & (dv > 0), dv, v_err)
        v_err = jnp.where(is_far & (rho < 1) & (dv < 0), dv, v_err)

        # stochastic PG + adaptive deterministic mix (MixedPG.cpp:46-55)
        pg_coef = jnp.where(is_far, 0.0, a_ret * rho)
        spg_m, spg_s = cp.pol_grad(mb.action, mean, sigma, sraw, pg_coef,
                                   self.bounded)
        f = jnp.where(jnp.abs(v_err) < NN_EPS, 0.0, 1.0 / v_err)
        dpg_n = jnp.where(is_far[:, None], 0.0, dpg * (v_err * f)[:, None])
        mix_m = spg_m + dpg_n * opt_state.dpg_factor[None, :]
        pn_m, pn_s = cp.kl_grad(mb.mu, mean, sigma, sraw,
                                -jnp.ones_like(rho))
        g_m = beta * mix_m + (1 - beta) * pn_m
        g_s = beta * spg_s + (1 - beta) * pn_s
        v_actor_err = jnp.where(
            is_far, 0.0,
            beta * jnp.minimum(1.0, rho) * (q_ret - a_est - v_act))

        # pull back: actor gets [g_m, v_actor_err, g_s]; critic gets
        # q_err at (s, a) and v_err at (s, mean) with mean stop-grad
        def ascent(net_p):
            m2, v2, sr2 = self._actor(net_p, mb.s_t)
            q_taken = self._critic(net_p, mb.s_t, mb.action)
            q_pol = self._critic(net_p, mb.s_t,
                                 jax.lax.stop_gradient(m2))
            s2 = cp.sigma_of(sr2)
            obj = (jnp.sum(jax.lax.stop_gradient(g_m) * m2)
                   + jnp.sum(jax.lax.stop_gradient(g_s) * sr2)
                   + jnp.sum(jax.lax.stop_gradient(v_actor_err) * v2)
                   + jnp.sum(jax.lax.stop_gradient(q_err) * q_taken)
                   + jnp.sum(jax.lax.stop_gradient(v_err) * q_pol))
            return obj

        # NOTE: g_s is d/d(raw stdev out); pol_grad/kl_grad already chain
        # the SoftPlus, so pair it with the raw sraw output.
        grads = jax.grad(ascent)(params)
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)
        new_net, new_adam = adam_step(params, grads, opt_state.adam,
                                      self.adam_cfg, 1.0 / cfg.batchSize)

        # adaptive DPG weight EMA (MixedPGstats::update)
        lr = cfg.learnrate
        std_spg = jnp.sqrt(jnp.maximum(
            jnp.mean(spg_m ** 2, 0) - jnp.mean(spg_m, 0) ** 2, 0.0))
        rms_dpg = jnp.sqrt(jnp.mean(dpg_n ** 2, 0) + NN_EPS)
        new_factor = opt_state.dpg_factor + lr * (
            0.2 * std_spg / rms_dpg - opt_state.dpg_factor)
        new_errq = opt_state.err_q_factor + lr * (
            jnp.mean(dq * dq) - opt_state.err_q_factor)
        new_opt = MixedPGOptState(adam=new_adam, dpg_factor=new_factor,
                                  err_q_factor=new_errq)

        m1, vn, _ = self._actor(params, mb.s_t1)
        v_next = (self._critic(params, mb.s_t1, m1) + vn) / 2
        rs = write_back_with_next(rs, mb, rho, dkl, a_ret - a_est, v_est,
                                  a_est, v_next)
        rs, frac_off = post_step_processing(rs, cfg, new_opt.step,
                                            a_ret - a_est, axis_name)
        metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                  a_ret - a_est, v_est, axis_name)
        from smarties_tpu.algos.base import grad_stats
        metrics.update(grad_stats(grads))
        return new_net, new_opt, rs, metrics

    # ------------------------------------------------------------------
    def refresh(self, rs: rb.ReplayState, n_grad_steps, axis_name=None):
        cfg = self.cfg
        rs = rb.recompute_returns(rs, cfg.gamma, cfg.lambda_,
                                  self.returns_mode)
        lr = anneal_rate(cfg.learnrate, n_grad_steps, cfg.epsAnneal)
        rs = rb.update_state_rew_stats(rs, 10.0 * lr, axis_name=axis_name)
        return rs

    def initialize_stats(self, rs: rb.ReplayState, axis_name=None):
        rs = rb.update_state_rew_stats(rs, 1.0, b_init=True,
                                       axis_name=axis_name)
        rs = rb.recompute_returns(rs, self.cfg.gamma, self.cfg.lambda_,
                                  self.returns_mode)
        return rs
