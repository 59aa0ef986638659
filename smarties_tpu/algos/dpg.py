"""DPG/DDPG: deterministic policy gradient with ReF-ER.

JAX re-expression of the reference DPG (source/smarties/Learners/
DPG.{h,cpp}): shared encoder + actor (mean + param-stdev exploration) +
Q-critic taking the action as an extra input; target networks on all parts;
critic learning rate x10 and L2 1e-4 (DPG.cpp:201-203); Retrace targets
(DPG.json) or 1-step TD with target nets; the policy-mean gradient is
dQ/da backpropped through the critic wrt its action input — the reference's
oneStepBackProp machinery (Approximator.h:207-251) is one jax.grad here;
ReF-ER mixes the KL penalty into the mean gradient (weightSum2Grads,
DPG.cpp:72-75); stdev is pulled toward explNoise (DPG_LEARN_STDEV off).

Deviation, deliberate: the reference evaluates dQ/da on the TARGET critic
activations (DPG.cpp:50 forward with sample -1); standard DDPG — and this
implementation — uses the ONLINE critic at the online actor's action.
The reference's 1-step branch also uses reward(t) (same off-by-one as DQN);
here r_{t+1}.

Recurrent nets (nnType LSTM/GRU/RNN): the recurrence lives in the shared
encoder trunk (created implicitly from nnLayerSizes[0] when no encoder is
configured) and the actor/critic heads are feedforward on its features —
one scanned recurrence shared by all heads; the reference
instead makes each net recurrent via Builder. BPTT windows come from the
same shared machinery as RACER (base.py, MemoryBuffer.cpp:393-402).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.algos.base import (default_metrics, gather_minibatch,
                                     post_step_processing, write_back_with_next)
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import NetSpec, apply_net, init_params
from smarties_tpu.models.optim import (AdamConfig, AdamState, adam_init,
                                       adam_step, update_target)
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.ops.softplus import softplus_diff
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32


class DPG:
    presample = True   # uniform sampling hoistable out of scan bodies
    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        assert not mdp.is_discrete, "DPG requires continuous actions"
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        self.recurrent = cfg.nnType in ("LSTM", "GRU", "RNN")
        enc_sizes = tuple(s for s in cfg.encoderLayerSizes if s > 0)
        if self.recurrent and not enc_sizes:
            # recurrence lives in the trunk; synthesize one from the
            # first hidden size (see module docstring)
            enc_sizes = (cfg.nnLayerSizes[0],)
        self.has_enc = len(enc_sizes) > 0
        head_kind = "FFNN" if self.recurrent else cfg.nnType
        feat = enc_sizes[-1] if self.has_enc else mdp.dim_net_input
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        if self.has_enc:
            # recurrent: all encoder sizes are (recurrent) hidden layers
            # with a same-size projection out; NetSpec recurrence lives in
            # hidden layers only
            enc_hidden = enc_sizes if self.recurrent else enc_sizes[:-1]
            self.enc_spec = NetSpec(
                n_in=mdp.dim_net_input, hidden=enc_hidden,
                n_out=enc_sizes[-1], kind=cfg.nnType, act=cfg.nnFunc,
                out_prefac=1.0, out_act=cfg.nnFunc)
        self.actor_spec = NetSpec(
            n_in=feat, hidden=tuple(cfg.nnLayerSizes), n_out=nA,
            kind=head_kind, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac,
            n_param_out=nA, param_init=tuple([sig0] * nA))
        self.critic_spec = NetSpec(
            n_in=feat + nA, hidden=tuple(cfg.nnLayerSizes), n_out=1,
            kind=head_kind, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac)
        self.bounded = np.asarray(mdp.bounded_mask)
        # critic wants lr x10 and L2 1e-4 (DPG.cpp:201-203)
        self.actor_adam = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                     eps_anneal=cfg.epsAnneal)
        self.critic_adam = AdamConfig(eta=10 * cfg.learnrate, lambda_=1e-4,
                                      eps_anneal=cfg.epsAnneal)
        self.returns_mode = ("none" if cfg.returnsEstimator == "default"
                             else cfg.returnsEstimator)
        self.ou_decay = 0.85 if cfg.clipImpWeight <= 0 else 0.0  # DPG.h:20

    # ------------------------------------------------------------------
    def init(self, key):
        ks = jax.random.split(key, 3)
        net = {"actor": init_params(ks[0], self.actor_spec),
               "critic": init_params(ks[1], self.critic_spec)}
        if self.has_enc:
            net["enc"] = init_params(ks[2], self.enc_spec)
        params = {"net": net, "tgt": jax.tree_util.tree_map(jnp.copy, net)}
        return params, adam_init(net)

    def init_rnn(self, n_envs: int):
        """Per-env carry: slot 0 the Ornstein-Uhlenbeck noise state
        (OrUhState analog, DPG.h/NAF.h), the rest the encoder's recurrent
        carry; zeroed on episode end by the collector."""
        from smarties_tpu.models.net import init_carry
        ou = jnp.zeros((n_envs, self.mdp.dim_action))
        enc = init_carry(self.enc_spec, (n_envs,)) if self.has_enc else ()
        return (ou,) + enc

    # ------------------------------------------------------------------
    def _feat(self, net, x):
        if self.has_enc:
            y, _ = apply_net(net["enc"], self.enc_spec, x)
            return y
        return x

    def _feat_seq(self, net, xs, active):
        """(feat_t, feat_t1) through the recurrent encoder over a BPTT
        window; differentiable (used inside the loss closure)."""
        from smarties_tpu.algos.base import seq_outputs
        return seq_outputs(net["enc"], self.enc_spec, xs, active)

    def _actor(self, net, feat):
        out, _ = apply_net(net["actor"], self.actor_spec, feat)
        nA = self.mdp.dim_action
        return out[..., :nA], out[..., nA:]

    def _critic(self, net, feat, action):
        q, _ = apply_net(net["critic"], self.critic_spec,
                         jnp.concatenate([feat, action], axis=-1))
        return q[..., 0]

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        bounded = self.bounded
        sample = train and self.cfg.explNoise > 0

        def act(params, obs_std, key, rnn=()):
            net = params["net"]
            ou_prev = rnn[0] if rnn else jnp.zeros(
                obs_std.shape[:-1] + (self.mdp.dim_action,))
            if self.has_enc:
                feat, enc_carry = apply_net(net["enc"], self.enc_spec,
                                            obs_std, rnn[1:] if rnn else ())
            else:
                feat, enc_carry = obs_std, ()
            mean, sraw = self._actor(net, feat)
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
            # appendValues(V = Q(s, pol(s)), Q = Q(s, a)) (DPG.cpp:100-105)
            v = self._critic(net, feat, mean)
            q = self._critic(net, feat, a)
            return a, mu, v, q - v, (ou,) + enc_carry

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   key, axis_name=None, sample_override=None):
        """DPG::Train (DPG.cpp:12-80) as one XLA program."""
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
        net, tgt = params["net"], params["tgt"]

        if self.recurrent:
            from smarties_tpu.algos.base import bptt_window
            xs, active = bptt_window(rs, ep, t, cfg.nnBPTTseq)

        def feats(p):
            """(feat at t, feat at t+1) for parameter set p."""
            if self.recurrent:
                return self._feat_seq(p, xs, active)
            return self._feat(p, mb.s_t), self._feat(p, mb.s_t1)

        # policy stats for ReF-ER
        feat_ng, feat1_on = jax.lax.stop_gradient(feats(net))
        mean, sraw = self._actor(net, feat_ng)
        sigma = cp.sigma_of(sraw)
        rho = cp.imp_weight(mb.action, mean, sigma, mb.mu, self.bounded)
        dkl = cp.kl_div(mb.mu, mean, sigma)
        is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)

        # targets
        if self.returns_mode != "none":
            target = mb.qret
            m1, _ = self._actor(net, feat1_on)
            v_next = self._critic(net, feat1_on, m1)
        else:
            feat1 = feats(tgt)[1]
            m1, _ = self._actor(tgt, feat1)
            v_next = self._critic(tgt, feat1, m1)
            target = mb.reward_next + jnp.where(
                mb.terminal_next | is_far, 0.0, cfg.gamma * v_next)

        # ---- combined loss whose gradient reproduces the reference's
        # hand-wired output gradients:
        #   critic ascent grad: (target - Q(s,a)), zeroed when far-policy
        #   actor mean grad: beta * dQ/da|_{a=pol(s)} + (1-beta) * (-dKL)
        #   actor stdev grad: pull sigma toward explNoise
        beta = rs.beta
        q_coef = jax.lax.stop_gradient(
            jnp.where(is_far, 0.0, target - self._critic(
                net, feat_ng, mb.action)))
        dpg_gate = jax.lax.stop_gradient(
            jnp.where(is_far, 0.0, beta * jnp.ones_like(rho)))

        def loss(net_p):
            feat = feats(net_p)[0]
            q_taken = self._critic(net_p, feat, mb.action)
            m, sr = self._actor(net_p, feat)
            # dQ/da through the critic only: stop feature/critic-params?
            # The reference backprops the critic's action-INPUT gradient
            # into the actor; critic weights get only the value loss.
            q_pol = self._critic(jax.lax.stop_gradient(net_p),
                                 jax.lax.stop_gradient(feat), m)
            s = cp.sigma_of(sr)
            kl = cp.kl_div(mb.mu, m, s)
            fix = -jnp.sum(jnp.square(cp.sigma_of(
                jax.lax.stop_gradient(sr) + (sr - jax.lax.stop_gradient(sr)))
                - cfg.explNoise), axis=-1) / 4
            # NOTE on fix: d/dsr of -(sigma-expl)^2/4 = -sp'(sr)(sigma-e)/2;
            # the reference uses +sp'(sr)*(e-sigma)/2 — identical.
            return jnp.sum(q_coef * q_taken
                           + dpg_gate * q_pol
                           - (1 - beta) * kl
                           + fix)

        grads = jax.grad(loss)(net)
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)

        # split Adam: critic (x10 lr, L2) vs actor/encoder
        g_actor = {k: v for k, v in grads.items() if k != "critic"}
        n_actor = {k: v for k, v in net.items() if k != "critic"}
        o_actor = AdamState(
            m1={k: v for k, v in opt_state.m1.items() if k != "critic"},
            m2={k: v for k, v in opt_state.m2.items() if k != "critic"},
            beta_t_1=opt_state.beta_t_1, beta_t_2=opt_state.beta_t_2,
            step=opt_state.step)
        new_actor, no_actor = adam_step(n_actor, g_actor, o_actor,
                                        self.actor_adam, 1.0 / cfg.batchSize)
        o_critic = AdamState(m1=opt_state.m1["critic"],
                             m2=opt_state.m2["critic"],
                             beta_t_1=opt_state.beta_t_1,
                             beta_t_2=opt_state.beta_t_2,
                             step=opt_state.step)
        new_critic, no_critic = adam_step(net["critic"], grads["critic"],
                                          o_critic, self.critic_adam,
                                          1.0 / cfg.batchSize)
        new_net = dict(new_actor, critic=new_critic)
        new_opt = AdamState(
            m1=dict(no_actor.m1, critic=no_critic.m1),
            m2=dict(no_actor.m2, critic=no_critic.m2),
            beta_t_1=no_actor.beta_t_1, beta_t_2=no_actor.beta_t_2,
            step=no_actor.step)
        new_tgt = update_target(new_net, tgt, cfg.targetDelay, new_opt.step)
        new_params = {"net": new_net, "tgt": new_tgt}

        q_val = self._critic(net, feat_ng, mb.action)
        v_val = self._critic(net, feat_ng, mean)
        err = target - q_val
        rs = write_back_with_next(rs, mb, rho, dkl, err, v_val,
                                  q_val - v_val, v_next)
        rs, frac_off = post_step_processing(rs, cfg, new_opt.step, err,
                                            axis_name)
        metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                  err, v_val, axis_name)
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
