"""PPO: on-policy clipped-surrogate policy optimization with GAE.

JAX re-expression of the reference PPO (source/smarties/Learners/
PPO.{h,cpp}, PPO_common.cpp, PPO_train.cpp): horizon buffer of
nHorizon == maxTotObsNum fresh transitions, nEpochs == batchSize/obsPerStep
passes of minibatch updates, then the buffer is cleared (PPO.cpp:96-115);
separate actor and critic (critic lr x3, PPO_common.cpp:70-74) over an
optional shared encoder; GAE returns (factory default).

Faithful reference quirks kept (default): the surrogate "gain" is
rho * (ret - V) zeroed by the clip test on the RETURN's sign
(PPO_train.cpp:41-46), and the learned Lagrange penalty coefficient +
adaptive DKL target are maintained (for metrics/possible use) even though
the reference mixes the KL-penalty gradient with weight 1 vs 0 — i.e.
pure clip (PPO_train.cpp:52). The faithful surrogate never demonstrates
learning on the repo envs (docs/RESULTS.md); `ppoStandard: true` swaps
in the published PPO-clip rule (ADVANTAGE-sign gating + per-batch
advantage normalization, DEVIATIONS #20) and solves cart-pole 500.0 /
pendulum -184.

Deviation, deliberate: the reference's critic gradient is gated to
far-policy samples ONLY (`verr * (isOff? 1 : 0)`, PPO_train.cpp:69), which
leaves the critic untrained on fresh on-policy data; here the critic trains
on all samples (standard PPO).

Recurrent nets (nnType LSTM/GRU/RNN): as in DPG, the recurrence lives in
the shared encoder trunk (synthesized from nnLayerSizes[0] if no encoder
is configured); actor/critic heads are feedforward. BPTT windows via the
shared base.py machinery.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.algos.base import gather_minibatch, write_back
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import (Conv2DDesc, NetSpec,
                                     apply_net, init_params)
from smarties_tpu.models.optim import (AdamConfig, AdamState, adam_init,
                                       adam_step)
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.ops import discrete_policy as dpol
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32


class PPOOptState(NamedTuple):
    adam: AdamState
    penal_coef: jnp.ndarray   # learned Lagrange coefficient (PPO.h:35)
    dkl_target: jnp.ndarray   # adaptive KL target (PPO.h:33)

    @property
    def step(self):
        return self.adam.step


class PPO:
    presample = True   # uniform sampling hoistable out of scan bodies
    on_policy = True

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        self.mdp = mdp
        self.cfg = cfg
        self.discrete = mdp.is_discrete
        nA = mdp.dim_action
        self.n_horizon = cfg.maxTotObsNum
        self.n_epochs = max(1, int(cfg.batchSize / cfg.obsPerStep))
        self.cmax_pol = cfg.clipImpWeight
        # standard PPO-clip mode (cfg.ppoStandard): clip gates on the
        # ADVANTAGE sign + per-batch advantage normalization; default
        # keeps the reference-faithful return-sign gating
        self.standard = bool(getattr(cfg, "ppoStandard", False))
        self.recurrent = cfg.nnType in ("LSTM", "GRU", "RNN")
        enc_sizes = tuple(s for s in cfg.encoderLayerSizes if s > 0)
        if self.recurrent and not enc_sizes:
            enc_sizes = (cfg.nnLayerSizes[0],)
        self.has_enc = len(enc_sizes) > 0
        head_kind = "FFNN" if self.recurrent else cfg.nnType
        feat = enc_sizes[-1] if self.has_enc else mdp.dim_net_input
        if self.has_enc:
            enc_hidden = enc_sizes if self.recurrent else enc_sizes[:-1]
            self.enc_spec = NetSpec(
                n_in=mdp.dim_net_input, hidden=enc_hidden,
                n_out=enc_sizes[-1], kind=cfg.nnType, act=cfg.nnFunc,
                out_prefac=1.0, out_act=cfg.nnFunc)
        if self.discrete:
            self.n_opts = mdp.max_action_label
            self.actor_spec = NetSpec(
                n_in=feat, hidden=tuple(cfg.nnLayerSizes),
                n_out=self.n_opts, kind=head_kind, act=cfg.nnFunc,
                out_prefac=cfg.outWeightsPrefac)
        else:
            sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
            self.actor_spec = NetSpec(
                n_in=feat, hidden=tuple(cfg.nnLayerSizes), n_out=nA,
                kind=head_kind, act=cfg.nnFunc,
                out_prefac=cfg.outWeightsPrefac,
                n_param_out=nA, param_init=tuple([sig0] * nA))
        self.critic_spec = NetSpec(
            n_in=feat, hidden=tuple(cfg.nnLayerSizes), n_out=1,
            kind=head_kind, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac)
        self.bounded = (None if self.discrete
                        else np.asarray(mdp.bounded_mask))
        self.actor_adam = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                     eps_anneal=cfg.epsAnneal)
        # critic lr x3 (PPO_common.cpp:70-74)
        self.critic_adam = AdamConfig(eta=3 * cfg.learnrate,
                                      lambda_=cfg.nnLambda,
                                      eps_anneal=cfg.epsAnneal)
        self.returns_mode = ("GAE" if cfg.returnsEstimator == "default"
                             else cfg.returnsEstimator)

    # ------------------------------------------------------------------
    def init(self, key):
        ks = jax.random.split(key, 3)
        net = {"actor": init_params(ks[0], self.actor_spec),
               "critic": init_params(ks[1], self.critic_spec)}
        if self.has_enc:
            net["enc"] = init_params(ks[2], self.enc_spec)
        opt = PPOOptState(adam=adam_init(net),
                          penal_coef=jnp.float32(1.0),
                          dkl_target=jnp.float32(self.cfg.klDivConstraint))
        return net, opt

    def _feat(self, net, x):
        if self.has_enc:
            y, _ = apply_net(net["enc"], self.enc_spec, x)
            return y
        return x

    def init_rnn(self, n_envs: int):
        from smarties_tpu.models.net import init_carry
        return init_carry(self.enc_spec, (n_envs,)) if self.has_enc else ()

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        bounded = self.bounded
        sample = train and self.cfg.explNoise > 0

        def act(params, obs_std, key, rnn=()):
            if self.has_enc:
                feat, rnn = apply_net(params["enc"], self.enc_spec,
                                      obs_std, rnn)
            else:
                feat = obs_std
            pol, _ = apply_net(params["actor"], self.actor_spec, feat)
            v, _ = apply_net(params["critic"], self.critic_spec, feat)
            value = v[..., 0]
            zeros = jnp.zeros_like(value)
            if self.discrete:
                _, _, probs = dpol.probs_of(pol)
                opt = dpol.select(key, probs, sample)
                return (opt[..., None].astype(F32), probs, value, zeros,
                        rnn)
            nA = self.mdp.dim_action
            mean, sraw = pol[..., :nA], pol[..., nA:]
            sigma = cp.sigma_of(sraw)
            a = cp.sample(key, mean, sigma, bounded) if sample \
                else cp.eff_mean(mean, bounded)
            mu = cp.mu_vector(mean, sigma, bounded)
            return a, mu, value, zeros, rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: PPOOptState,
                   rs: rb.ReplayState, key, axis_name=None, sample_override=None):
        """PPO::Train (PPO_train.cpp:19-71) + updatePenalizationCoef
        (:5-16) as one XLA program."""
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
            ep, t = rb.sample(k_samp, rs, B, self.cfg.dataSamplingAlgo)
        mb = gather_minibatch(rs, ep, t)
        value_old = mb.value_old     # V recorded at acting time (rides
        # along in the packed minibatch-record gather)

        if self.recurrent:
            from smarties_tpu.algos.base import bptt_window, seq_outputs
            xs, active = bptt_window(rs, ep, t, cfg.nnBPTTseq)

        def loss(net):
            if self.recurrent:
                feat = seq_outputs(net["enc"], self.enc_spec,
                                   xs, active)[0]
            else:
                feat = self._feat(net, mb.s_t)
            pol, _ = apply_net(net["actor"], self.actor_spec, feat)
            v, _ = apply_net(net["critic"], self.critic_spec, feat)
            v = v[..., 0]
            if self.discrete:
                opt = mb.action[..., 0].astype(jnp.int32)
                _, _, probs = dpol.probs_of(pol)
                logp = dpol.logprob(opt, probs)
                logmu = jnp.log(jnp.maximum(jnp.take_along_axis(
                    mb.mu, opt[..., None], axis=-1)[..., 0], 1e-38))
                rho = jnp.exp(logp - logmu)
                dkl = dpol.kl_mu_pi(mb.mu, probs)
            else:
                mean, sraw = pol[..., :nA], pol[..., nA:]
                sigma = cp.sigma_of(sraw)
                logp = cp.logprob(mb.action, mean, sigma, self.bounded)
                rho = cp.imp_weight(mb.action, mean, sigma, mb.mu,
                                    self.bounded)
                dkl = cp.kl_div(mb.mu, mean, sigma)

            adv = mb.qret - value_old
            if self.standard:
                # standard PPO-clip (ppoStandard): the gradient of
                # min(rho*A, clip(rho, 1-eps, 1+eps)*A) is A*rho*dlogpi
                # zeroed when (A>0 and rho>1+eps) or (A<0 and rho<1-eps);
                # advantages are normalized per batch (mask-aware so
                # empty-shard rows don't skew the moments)
                w = mb.valid.astype(F32)
                n = jnp.maximum(jnp.sum(w), 1.0)
                a_mu = jnp.sum(adv * w) / n
                a_sd = jnp.sqrt(jnp.maximum(
                    jnp.sum(w * (adv - a_mu) ** 2) / n, 1e-8))
                adv_n = (adv - a_mu) / a_sd
                gain = jnp.where(
                    (adv_n > 0) & (rho > 1 + self.cmax_pol), 0.0,
                    jnp.where((adv_n < 0) & (rho < 1 - self.cmax_pol),
                              0.0, rho * adv_n))
            else:
                # gain = rho * adv with the reference's clip-on-RETURN
                # gating (PPO_train.cpp:41-46); the gradient is
                # gain * dlogpi (policyGradient(act, gain)), so:
                # surr = stopgrad(gain) * logp
                gain = jnp.where(
                    (mb.qret > 0) & (rho > 1 + self.cmax_pol), 0.0,
                    jnp.where((mb.qret < 0) & (rho < 1 - self.cmax_pol),
                              0.0, rho * adv))
            surr = jax.lax.stop_gradient(gain) * logp
            verr = mb.qret - v
            # NOTE: reference gates the critic to far-policy samples only
            # (PPO_train.cpp:69) — deliberately trained on all here
            vloss = 0.5 * verr * verr
            aux = (rho, dkl, verr)
            return jnp.sum(vloss - surr), aux

        grads, (rho, dkl, verr) = jax.grad(
            lambda p: loss(p), has_aux=True)(params)
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)

        is_off = (rho > 1 + self.cmax_pol) | (rho < 1 - self.cmax_pol)

        # ---- split Adam: critic x3 lr ----
        # adam_step applies ASCENT; loss gradients are descent directions
        g_actor = jax.tree_util.tree_map(
            lambda x: -x, {k: v for k, v in grads.items() if k != "critic"})
        g_critic = jax.tree_util.tree_map(lambda x: -x, grads["critic"])
        n_actor = {k: v for k, v in params.items() if k != "critic"}
        adam = opt_state.adam
        o_actor = AdamState(
            m1={k: v for k, v in adam.m1.items() if k != "critic"},
            m2={k: v for k, v in adam.m2.items() if k != "critic"},
            beta_t_1=adam.beta_t_1, beta_t_2=adam.beta_t_2, step=adam.step)
        new_actor, no_actor = adam_step(n_actor, g_actor, o_actor,
                                        self.actor_adam, 1.0 / cfg.batchSize)
        o_critic = AdamState(m1=adam.m1["critic"], m2=adam.m2["critic"],
                             beta_t_1=adam.beta_t_1,
                             beta_t_2=adam.beta_t_2, step=adam.step)
        new_critic, no_critic = adam_step(params["critic"], g_critic,
                                          o_critic, self.critic_adam,
                                          1.0 / cfg.batchSize)
        new_params = dict(new_actor, critic=new_critic)
        new_adam = AdamState(
            m1=dict(no_actor.m1, critic=no_critic.m1),
            m2=dict(no_actor.m2, critic=no_critic.m2),
            beta_t_1=no_actor.beta_t_1, beta_t_2=no_actor.beta_t_2,
            step=no_actor.step)

        # ---- Lagrange coefficient + adaptive DKL target ----
        # (updatePenalizationCoef PPO_train.cpp:5-16, updateDKL_target
        # PPO_common.cpp:8-16) — batch-aggregated
        tgt = opt_state.dkl_target
        penal = opt_state.penal_coef
        n_lo = jnp.sum((dkl < tgt / 1.5).astype(F32))
        n_hi = jnp.sum((dkl > 1.5 * tgt).astype(F32))
        cnt = jnp.float32(B)
        if axis_name is not None:
            n_lo = jax.lax.psum(n_lo, axis_name)
            n_hi = jax.lax.psum(n_hi, axis_name)
            cnt = jax.lax.psum(cnt, axis_name)
        delta = n_hi * penal - n_lo * penal / 2
        penal = jnp.maximum(penal + 1e-4 * delta / jnp.maximum(cnt, 1.0),
                            1.19e-7)
        n_shrink = jnp.sum((is_off & (tgt > dkl)).astype(F32))
        n_grow = jnp.sum(((~is_off) & (tgt < dkl)).astype(F32))
        if axis_name is not None:
            n_shrink = jax.lax.psum(n_shrink, axis_name)
            n_grow = jax.lax.psum(n_grow, axis_name)
        tgt = tgt * (0.9995 ** n_shrink) * (1.0001 ** n_grow)
        new_opt = PPOOptState(adam=new_adam, penal_coef=penal,
                              dkl_target=tgt)

        rs = write_back(rs, mb, rho, dkl, verr, value_old,
                        jnp.zeros_like(verr))
        metrics = {
            "avg_dkl": jnp.mean(dkl), "avg_rho": jnp.mean(rho),
            "frac_far_batch": jnp.mean(is_off.astype(F32)),
            "frac_far_data": jnp.float32(0.0),
            "beta": penal, "rmse": jnp.sqrt(jnp.mean(verr * verr)),
            "avg_v": jnp.mean(value_old),
        }
        from smarties_tpu.algos.base import grad_stats
        metrics.update(grad_stats(grads))
        return new_params, new_opt, rs, metrics

    # ------------------------------------------------------------------
    def refresh(self, rs: rb.ReplayState, n_grad_steps, axis_name=None):
        """On the PPO cadence the host calls this once per horizon epoch
        (updateRewardsStats, PPO.cpp:100-104)."""
        lr = anneal_rate(self.cfg.learnrate, n_grad_steps,
                         self.cfg.epsAnneal)
        return rb.update_state_rew_stats(rs, jnp.minimum(1.0, lr),
                                         axis_name=axis_name)

    def initialize_stats(self, rs: rb.ReplayState, axis_name=None):
        rs = rb.update_state_rew_stats(rs, 1.0, b_init=True,
                                       axis_name=axis_name)
        rs = rb.recompute_returns(rs, self.cfg.gamma, self.cfg.lambda_,
                                  self.returns_mode)
        return rs
