"""RACER / V-RACER: off-policy policy gradient with ReF-ER + Retrace.

JAX re-expression of the reference's RACER template family
(source/smarties/Learners/RACER.{h,cpp}, RACER_common.cpp, RACER_train.cpp),
covering the three factory instantiations (AlgoFactory.cpp:96-153):

- V-RACER   = RACER<Zero_advantage, Continuous_policy>   (adv == 0, Q == V)
- RACER     = RACER<Gaussian_advantage, Continuous_policy>
- RACER-dis = RACER<Discrete_advantage, Discrete_policy>  (V-RACER with
  discrete actions is auto-rewritten to this, AlgoFactory.cpp:78-83)

One network outputs [V | advantage params | policy params] (+ a trainable
state-independent stdev head for continuous policies, RACER_simpleSigma,
RACER_common.cpp:77-108). Training is ONE jitted function: sample
minibatch -> batched forward -> analytic output-space gradients (ReF-ER
beta mix of policy gradient and KL penalty, far-policy gated;
RACER_train.cpp:14-67) -> vjp pullback -> Adam ascent -> scatter
write-backs of rho/KL/TD-error into the on-device replay. The reference
spreads this across OpenMP train tasks + a TaskQueue state machine
(RACER.cpp:62-110); here the whole grad step is one XLA program.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.algos.base import (default_metrics, gather_minibatch,
                                     post_step_processing,
                                     write_back_with_next)
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import (Conv2DDesc, NetSpec,
                                     apply_net, init_params)
from smarties_tpu.models.optim import (AdamConfig, AdamState, adam_init,
                                       adam_step)
from smarties_tpu.ops import advantages as adv_ops
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.ops import discrete_policy as dpol
from smarties_tpu.ops.value_scale import scale_net2v, scale_vdiff
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32


class VRacer:
    """RACER family learner. adv_kind selects the advantage family; the
    default follows the factory rules from cfg.learner."""
    presample = True   # uniform sampling hoistable out of scan bodies


    def __init__(self, mdp: MDPSpec, cfg: HyperParameters,
                 adv_kind: str | None = None):
        self.mdp = mdp
        self.cfg = cfg
        self.discrete = mdp.is_discrete
        nA = mdp.dim_action
        if adv_kind is None:
            if self.discrete:
                adv_kind = "discrete"   # AlgoFactory.cpp:78-83 auto-rewrite
            else:
                adv_kind = "zero" if cfg.learner in ("VRACER", "default") \
                    else "gaussian"
        self.adv_kind = adv_kind

        if self.discrete:
            n_opts = mdp.max_action_label
            self.n_opts = n_opts
            self.nL = adv_ops.discrete_n_outputs(n_opts)
            # outputs: [V, adv(nOpts), pol(nOpts)] (RACER_common.cpp:121-123)
            self.adv_start, self.pol_start = 1, 1 + self.nL
            self.spec = NetSpec(
                n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
                conv=tuple(Conv2DDesc(*c) for c in mdp.conv_layers),
                n_out=1 + self.nL + n_opts, kind=cfg.nnType, act=cfg.nnFunc,
                out_prefac=cfg.outWeightsPrefac,
                compute_dtype=("bfloat16" if cfg.nnBf16 else "float32"))
        else:
            self.nL = (0 if adv_kind == "zero"
                       else adv_ops.gaussian_n_outputs(nA))
            self.adv_start, self.pol_start = 1, 1 + self.nL
            sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
            bias = [0.0] + (adv_ops.gaussian_initial_bias(nA)
                            if self.nL else []) + [0.0] * nA
            self.spec = NetSpec(
                n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
                conv=tuple(Conv2DDesc(*c) for c in mdp.conv_layers),
                n_out=1 + self.nL + nA, kind=cfg.nnType, act=cfg.nnFunc,
                out_prefac=cfg.outWeightsPrefac,
                compute_dtype=("bfloat16" if cfg.nnBf16 else "float32"),
                n_param_out=nA, param_init=tuple([sig0] * nA),
                out_bias_init=tuple(bias))
        self.bounded = (None if self.discrete
                        else np.asarray(mdp.bounded_mask))
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        self.returns_mode = ("retrace" if cfg.returnsEstimator
                             in ("default", "retrace")
                             else cfg.returnsEstimator)

    # ------------------------------------------------------------------
    def init(self, key):
        params = init_params(key, self.spec)
        return params, adam_init(params)

    def init_rnn(self, n_envs: int):
        from smarties_tpu.models.net import init_carry
        return init_carry(self.spec, (n_envs,))

    # ------------------------------------------------------------------
    def _split_out(self, out):
        """-> (v_raw, adv_out, pol_out, sigma_raw|None)."""
        nA = self.mdp.dim_action
        v_raw = out[..., 0]
        adv = out[..., self.adv_start:self.adv_start + self.nL]
        if self.discrete:
            pol = out[..., self.pol_start:self.pol_start + self.n_opts]
            return v_raw, adv, pol, None
        pol = out[..., self.pol_start:self.pol_start + nA]
        sraw = out[..., self.pol_start + nA:self.pol_start + 2 * nA]
        return v_raw, adv, pol, sraw

    def _advantage(self, adv_out, action_or_opt, pol, sigma=None,
                   probs=None):
        """A(s, a) for the configured family."""
        if self.adv_kind == "zero":
            return jnp.zeros(adv_out.shape[:-1], F32)
        if self.discrete:
            return adv_ops.discrete_advantage(adv_out, action_or_opt, probs)
        m_eff = cp.eff_mean(pol, self.bounded)
        return adv_ops.gaussian_advantage(adv_out, action_or_opt, m_eff,
                                          sigma * sigma)

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """Batched action selection (RACER::selectAction, RACER.cpp:31-47):
        forward, sample, record V and Q = V + A(a)."""
        spec, mdp, bounded = self.spec, self.mdp, self.bounded
        discrete = self.discrete

        def act(params, obs_std, key, rnn=()):
            out, rnn = apply_net(params, spec, obs_std, rnn)
            v_raw, adv_out, pol, sraw = self._split_out(out)
            value = scale_net2v(v_raw)
            if discrete:
                _, _, probs = dpol.probs_of(pol)
                opt = dpol.select(key, probs, train)
                a_val = self._advantage(adv_out, opt, pol, probs=probs)
                return (opt[..., None].astype(F32), probs, value, a_val,
                        rnn)
            sigma = cp.sigma_of(sraw)
            if train:
                share = (mdp.n_agents_per_env
                         if mdp.shared_noise else 1)
                a = cp.sample(key, pol, sigma, bounded,
                              share_agents=share)
            else:
                a = cp.eff_mean(pol, bounded)
            mu = cp.mu_vector(pol, sigma, bounded)
            a_val = self._advantage(adv_out, a, pol, sigma=sigma)
            return a, mu, value, a_val, rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   key, axis_name=None, sample_override=None):
        """One gradient step (RACER_train.cpp:14-67 as one XLA program).

        When axis_name is given, runs inside shard_map over a learner mesh
        axis: each shard samples batchSize/n_shards transitions from ITS
        replay shard, gradients are psum'd before Adam (the reference's
        MPI_Iallreduce across learners_train_comm, Optimizer.cpp:110-119).

        sample_override: optional pinned (ep, t) local sample indices —
        used by the exact cross-layout gradient-parity tests.
        """
        cfg, mdp = self.cfg, self.mdp
        n_shards = (jax.lax.psum(1, axis_name) if axis_name is not None
                    else 1)
        B = cfg.batchSize // n_shards if axis_name is not None \
            else cfg.batchSize
        if axis_name is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        k_samp, = jax.random.split(key, 1)

        if sample_override is not None:
            ep, t = sample_override
        else:
            ep, t = rb.sample(k_samp, rs, B, self.cfg.dataSamplingAlgo)
        from smarties_tpu.algos.base import nhwc_probe_hw
        mb = gather_minibatch(rs, ep, t,
                              n_appended=self.mdp.n_appended_obs,
                              nhwc_hw=nhwc_probe_hw(self.spec, self.mdp))
        a_t, mu_t, qret_t = mb.action, mb.mu, mb.qret

        spec = self.spec

        def fwd(p, x):
            out, _ = apply_net(p, spec, x)
            return out

        if spec.is_recurrent:
            # Truncated BPTT over a window ending at the sampled step
            # (reference: per-sample windows [t - nnBPTTseq, t + 2) with
            # zeroed context at window start, MemoryBuffer.cpp:393-402,
            # Network.h:155-193 backProp). Shared machinery in base.py.
            from smarties_tpu.algos.base import bptt_window, seq_forward_vjp
            xs, active = bptt_window(rs, ep, t, cfg.nnBPTTseq)
            out, out_next_pre, pullback = seq_forward_vjp(
                params, spec, xs, active)
        else:
            # ONE forward over [s_t; s_t1] instead of two: the t+1 values
            # (V(s_T) refresh, RACER_train.cpp:22-27) ride along in the
            # same kernel chain — halves the per-step kernel count of a
            # small-model step. The s_t1 rows get ZERO cotangents in the
            # pullback, so gradients are bit-identical to the
            # two-forward version.
            B2 = mb.s_t.shape[0]
            xcat = jnp.concatenate([mb.s_t, mb.s_t1], axis=0)
            out_cat, vjp_fn = jax.vjp(lambda p: fwd(p, xcat), params)
            out, out_next_pre = out_cat[:B2], out_cat[B2:]

            def pullback(g):
                return vjp_fn(jnp.concatenate(
                    [g, jnp.zeros_like(g)], axis=0))[0]

        v_raw, adv_out, pol, sraw = self._split_out(out)
        v_val = scale_net2v(v_raw)

        if self.discrete:
            opt = a_t[..., 0].astype(jnp.int32)
            un, norm, probs = dpol.probs_of(pol)
            rho = dpol.imp_weight(opt, probs, mu_t)
            dkl = dpol.kl_mu_pi(mu_t, probs)
            a_val = self._advantage(adv_out, opt, pol, probs=probs)
        else:
            sigma = cp.sigma_of(sraw)
            rho = cp.imp_weight(a_t, pol, sigma, mu_t, self.bounded)
            dkl = cp.kl_div(mu_t, pol, sigma)
            a_val = self._advantage(adv_out, a_t, pol, sigma=sigma)

        cmax, cinv, beta = rs.cmax_ret, rs.cinv_ret, rs.beta
        is_far = rb.is_far_policy(rho, cmax, cinv)

        a_ret = qret_t - v_val                # Retrace advantage
        delta_q = a_ret - a_val               # TD error
        ver = jnp.minimum(1.0, rho) * delta_q
        aer = jnp.minimum(cmax, rho) * delta_q

        # ---- analytic output gradient (ascent), RACER_train.cpp:46-57 ----
        g_v = jnp.where(is_far, 0.0, ver * beta * scale_vdiff(v_raw))
        pg_coef = jnp.where(is_far, 0.0, a_ret * jnp.minimum(cmax, rho))
        if self.discrete:
            pol_g = dpol.pol_grad(opt, pol, un, norm, probs, pg_coef)
            pol_g = jnp.where(is_far[:, None], 0.0, pol_g)
            pen_g = dpol.kl_grad(mu_t, pol, un, norm, probs,
                                 -jnp.ones_like(pg_coef))
            g_pol = beta * pol_g + (1 - beta) * pen_g
        else:
            pg_m, pg_s = cp.pol_grad(a_t, pol, sigma, sraw, pg_coef,
                                     self.bounded)
            pg_m = jnp.where(is_far[:, None], 0.0, pg_m)
            pg_s = jnp.where(is_far[:, None], 0.0, pg_s)
            pn_m, pn_s = cp.kl_grad(mu_t, pol, sigma, sraw,
                                    -jnp.ones_like(pg_coef))
            g_pol = jnp.concatenate([beta * pg_m + (1 - beta) * pn_m,
                                     beta * pg_s + (1 - beta) * pn_s],
                                    axis=-1)

        # advantage-head gradient: ADV.grad(a, isFar? 0 : beta*Aer)
        # via per-sample autodiff of the advantage (ops/advantages.py)
        if self.nL > 0:
            adv_coef = jnp.where(is_far, 0.0, beta * aer)
            if self.discrete:
                g_adv = jax.vmap(jax.grad(
                    lambda ao, o, p: adv_ops.discrete_advantage(
                        ao, o, p)))(adv_out, opt, probs)
            else:
                m_eff = cp.eff_mean(pol, self.bounded)
                g_adv = jax.vmap(jax.grad(
                    lambda ao, a, m, v: adv_ops.gaussian_advantage(
                        ao, a, m, v)))(adv_out, a_t, m_eff, sigma * sigma)
            g_adv = adv_coef[:, None] * g_adv
            g = jnp.concatenate([g_v[:, None], g_adv, g_pol], axis=-1)
        else:
            g = jnp.concatenate([g_v[:, None], g_pol], axis=-1)

        # empty-shard samples contribute no gradient (MiniBatch.valid)
        g = jnp.where(mb.valid[:, None], g, 0.0)
        grads = pullback(g)
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)
        new_params, new_opt = adam_step(params, grads, opt_state,
                                        self.adam_cfg, 1.0 / cfg.batchSize)

        # ---- write-backs (MiniBatch::setMseDklImpw / setValues) ----
        # write-backs + V(s_T) refresh when the sampled step precedes a
        # truncation (RACER_train.cpp:22-27): ONE fused scatter
        out_next = (jax.lax.stop_gradient(out_next_pre)
                    if out_next_pre is not None else fwd(params, mb.s_t1))
        v_next = scale_net2v(out_next[..., 0])
        rs = write_back_with_next(rs, mb, rho, dkl, delta_q, v_val, a_val,
                                  v_next)

        rs, frac_off = post_step_processing(rs, cfg, new_opt.step, delta_q,
                                            axis_name)
        metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                  delta_q, v_val, axis_name)
        from smarties_tpu.algos.base import grad_stats
        metrics.update(grad_stats(grads))
        return new_params, new_opt, rs, metrics

    # ------------------------------------------------------------------
    def refresh(self, rs: rb.ReplayState, n_grad_steps, axis_name=None):
        """Every-1000-steps sweep (updateTrainingStatistics recompute branch
        + updateRewardsStats(.., rRateFac=10), Learner.cpp:74-100).

        Order preserved: returns recomputed with the OLD reward scaling,
        then scaling updated (affects subsequent ingests/sweeps)."""
        cfg = self.cfg
        rs = rb.recompute_returns(rs, cfg.gamma, cfg.lambda_,
                                  self.returns_mode)
        lr = anneal_rate(cfg.learnrate, n_grad_steps, cfg.epsAnneal)
        rs = rb.update_state_rew_stats(rs, 10.0 * lr, axis_name=axis_name)
        return rs

    # ------------------------------------------------------------------
    def initialize_stats(self, rs: rb.ReplayState, axis_name=None):
        """At training start: exact state/reward stats from gathered data,
        then rescale all return estimators (Learner::initializeLearner,
        Learner.cpp:47-72)."""
        rs = rb.update_state_rew_stats(rs, 1.0, b_init=True,
                                       axis_name=axis_name)
        rs = rb.recompute_returns(rs, self.cfg.gamma, self.cfg.lambda_,
                                  self.returns_mode)
        return rs


class Racer(VRacer):
    """Full RACER (Gaussian advantage for continuous actions)."""

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        super().__init__(mdp, cfg,
                         adv_kind="discrete" if mdp.is_discrete
                         else "gaussian")
