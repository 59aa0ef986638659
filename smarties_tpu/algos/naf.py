"""NAF: normalized advantage functions with quadratic advantage.

JAX re-expression of the reference NAF (source/smarties/Learners/
NAF.{h,cpp}, default Param_advantage == Quadratic_advantage): one network
outputs [V, lower-triangular L params, mean] plus a trainable stdev head
used only for exploration; Q(s,a) = V - 0.5 (a-m)^T LL^T (a-m). Targets are
Retrace (NAF.json) or 1-step with a target network; the exploration stdev
is pulled toward explNoise by fixExplorationGrad (NAF.cpp:160-161), and
ReF-ER mixes the KL penalty into the mean gradient only (NAF.cpp:156-159).

NAF uses the RAW network value output (no R2D2 value rescale — unlike
RACER, compare NAF.cpp:60 with RACER.cpp:44).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.algos.base import (bptt_window, default_metrics,
                                     gather_minibatch, post_step_processing,
                                     seq_forward_vjp, seq_outputs,
                                     write_back_with_next)
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import (Conv2DDesc, NetSpec,
                                     apply_net, init_params)
from smarties_tpu.models.optim import (AdamConfig, AdamState, adam_init,
                                       adam_step, update_target)
from smarties_tpu.ops import advantages as adv_ops
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.ops.softplus import softplus_diff
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32


def _hard_sigmoid(x):
    """Quadratic_term::BoundedActFunction (Functions.h:255-283)."""
    return 0.5 * (1 + x / jnp.sqrt(1 + x * x))


class NAF:
    presample = True   # uniform sampling hoistable out of scan bodies
    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        assert not mdp.is_discrete, "NAF requires continuous actions"
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        # nafAdvGaussian re-expresses the reference's NAF_ADV_GAUS
        # compile switch (NAF.cpp:15-21: Param_advantage =
        # Gaussian_advantage). NOTE the reference branch is bit-rotted —
        # it cannot compile (prepare_advantage, NAF.cpp:26-30, passes 3
        # args; Gaus_advantage.h:43-48 has only a 4-arg ctor needing the
        # policy) — so this is the faithful-intent completion: the
        # asymmetric-Gaussian bump advantage centered on the policy
        # mean, with the mean trained through the bump center (the
        # quadratic variant trains its mean the same way: the mean IS an
        # advantage parameter).
        self.gaussian = bool(getattr(cfg, "nafAdvGaussian", False))
        self.nL = (adv_ops.gaussian_n_outputs(nA) if self.gaussian
                   else adv_ops.quadratic_n_outputs(nA))
        # outputs: [V(1), L(nL), mean(nA)] + param stdev(nA) (NAF.cpp:39-44)
        self.v_idx, self.l_start, self.m_start = 0, 1, 1 + self.nL
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        # Gaus_advantage.h:30-36 setInitial biases the coef head to -1
        # and the width heads to +1
        ob = (tuple([0.0] + adv_ops.gaussian_initial_bias(nA)
                    + [0.0] * nA) if self.gaussian else ())
        self.spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
                conv=tuple(Conv2DDesc(*c) for c in mdp.conv_layers),
            n_out=1 + self.nL + nA, kind=cfg.nnType, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac, out_bias_init=ob,
            n_param_out=nA, param_init=tuple([sig0] * nA))
        self.bounded = np.asarray(mdp.bounded_mask)
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        self.returns_mode = ("none" if cfg.returnsEstimator == "default"
                             else cfg.returnsEstimator)
        self.ou_decay = 0.85 if cfg.clipImpWeight <= 0 else 0.0  # NAF.h:25

    # ------------------------------------------------------------------
    def init(self, key):
        net = init_params(key, self.spec)
        params = {"net": net, "tgt": jax.tree_util.tree_map(jnp.copy, net)}
        return params, adam_init(net)

    def init_rnn(self, n_envs: int):
        """Per-env carry: slot 0 is the Ornstein-Uhlenbeck noise state
        (OrUhState analog, DPG.h/NAF.h), the rest the net's recurrent
        carry; both are zeroed on episode end by the collector."""
        from smarties_tpu.models.net import init_carry
        ou = jnp.zeros((n_envs, self.mdp.dim_action))
        return (ou,) + init_carry(self.spec, (n_envs,))

    def _split(self, out):
        nA = self.mdp.dim_action
        v = out[..., 0]
        l_out = out[..., self.l_start:self.l_start + self.nL]
        mean = out[..., self.m_start:self.m_start + nA]
        sraw = out[..., self.m_start + nA:self.m_start + 2 * nA]
        return v, l_out, mean, sraw

    def _adv_mean(self, mean_raw):
        """Quadratic_term::extract_mean maps bounded dims through
        HardSigmoid (Quadratic_term.h:75-86)."""
        b = jnp.asarray(self.bounded)
        return jnp.where(b, _hard_sigmoid(mean_raw), mean_raw)

    def _advantage(self, l_out, mean_raw, action, sigma=None):
        if self.gaussian:
            return self._gauss_adv(l_out, mean_raw, action, sigma)
        return adv_ops.quadratic_advantage(
            l_out, self._adv_mean(mean_raw), action, self.mdp.dim_action)

    def _gauss_adv(self, adv_out, mean_raw, action, sigma):
        """Asymmetric-Gaussian advantage (Gaus_advantage.h:75-88)
        centered on the policy mean, with the mean trained THROUGH the
        bump center (stop_policy_grad=False): NAF is Q-learning with no
        policy gradient, exactly as the quadratic variant trains its own
        mean. The mix-ratio variance stays stop-gradient'd inside the
        shared helper (the stdev head is trained only by
        fixExplorationGrad, NAF.cpp:160-161)."""
        return adv_ops.gaussian_advantage(
            adv_out, action, cp.eff_mean(mean_raw, self.bounded),
            sigma * sigma, stop_policy_grad=False)

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        spec, bounded = self.spec, self.bounded
        sample = train and self.cfg.explNoise > 0

        def act(params, obs_std, key, rnn=()):
            # carry layout: (OU noise state, *net recurrent carry)
            ou_prev = rnn[0] if rnn else jnp.zeros(
                obs_std.shape[:-1] + (self.mdp.dim_action,))
            out, carry = apply_net(params["net"], spec, obs_std,
                                   rnn[1:] if rnn else ())
            v, l_out, mean, sraw = self._split(out)
            sigma = cp.sigma_of(sraw)
            ou = ou_prev
            if sample and self.ou_decay > 0:
                noise = cp.clipped_normal(key, mean.shape, mean.dtype)
                a, ou = cp.sample_ou(noise, ou_prev, mean, sigma, bounded)
            elif sample:
                a = cp.sample(key, mean, sigma, bounded)
            else:
                a = cp.eff_mean(mean, bounded)
            mu = cp.mu_vector(mean, sigma, bounded)
            a_val = self._advantage(l_out, mean, a, sigma)
            return a, mu, v, a_val, (ou,) + carry

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   key, axis_name=None, sample_override=None):
        """NAF::Train (NAF.cpp:121-165) as one XLA program."""
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

        spec = self.spec

        def fwd(p, x):
            out, _ = apply_net(p, spec, x)
            return out

        if spec.is_recurrent:
            xs, active = bptt_window(rs, ep, t, cfg.nnBPTTseq)
            out, out_next, pullback = seq_forward_vjp(
                params["net"], spec, xs, active)
        else:
            out, vjp_fn = jax.vjp(lambda p: fwd(p, mb.s_t), params["net"])
            out_next = None

            def pullback(g):
                return vjp_fn(g)[0]
        v, l_out, mean, sraw = self._split(out)
        sigma = cp.sigma_of(sraw)
        rho = cp.imp_weight(mb.action, mean, sigma, mb.mu, self.bounded)
        dkl = cp.kl_div(mb.mu, mean, sigma)
        a_val = self._advantage(l_out, mean, mb.action, sigma)
        q_val = v + a_val
        is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)

        if self.returns_mode != "none":
            target = mb.qret
            v_next = (out_next[..., 0] if spec.is_recurrent
                      else fwd(params["net"], mb.s_t1)[..., 0])
        else:
            v_next = (seq_outputs(params["tgt"], spec, xs, active)[1][..., 0]
                      if spec.is_recurrent
                      else fwd(params["tgt"], mb.s_t1)[..., 0])
            target = mb.reward_next + jnp.where(
                mb.terminal_next | is_far, 0.0, cfg.gamma * v_next)

        error = jnp.where(is_far, 0.0, target - q_val)

        # output gradient: value + advantage (autodiff) + ReF-ER mean mix +
        # stdev pulled to explNoise (NAF.cpp:148-161)
        g_adv = jax.vmap(jax.grad(
            lambda lo, m, s, a: self._advantage(lo[None], m[None],
                                                a[None], s[None])[0],
            argnums=(0, 1)))(l_out, mean, sigma, mb.action)
        g_l = error[:, None] * g_adv[0]
        g_m = error[:, None] * g_adv[1]
        if cfg.clipImpWeight > 0:
            pn_m, _ = cp.kl_grad(mb.mu, mean, sigma, sraw,
                                 -jnp.ones_like(rho))
            g_m = rs.beta * g_m + (1 - rs.beta) * pn_m
        # fixExplorationGrad (Continuous_policy.h:172-177)
        g_s = softplus_diff(sraw) * (cfg.explNoise - sigma) / 2
        g = jnp.concatenate([error[:, None], g_l, g_m, g_s], axis=-1)

        grads = pullback(g)
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)
        new_net, new_opt = adam_step(params["net"], grads, opt_state,
                                     self.adam_cfg, 1.0 / cfg.batchSize)
        new_tgt = update_target(new_net, params["tgt"], cfg.targetDelay,
                                new_opt.step)
        new_params = {"net": new_net, "tgt": new_tgt}

        rs = write_back_with_next(rs, mb, rho, dkl, error, v, a_val,
                                  v_next)
        rs, frac_off = post_step_processing(rs, cfg, new_opt.step, error,
                                            axis_name)
        metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                  error, v, axis_name)
        from smarties_tpu.algos.base import grad_stats
        metrics.update(grad_stats(grads))
        return new_params, new_opt, rs, metrics

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
