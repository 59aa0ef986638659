"""DQN with Boltzmann (soft) policy and optional ReF-ER + Retrace.

JAX re-expression of the reference DQN (source/smarties/Learners/
DQN.cpp, compiled with DQN_USE_POLICY): the Q-network doubles as an
Exp-normalized categorical policy (Discrete_policy_t<Exp> over raw Q values)
enabling importance weights and ReF-ER; 1-step double-Q targets with a
Polyak/periodic target network (DQN.cpp:173-185), or Retrace targets when
returnsEstimator != none (DQN.cpp:161-171).

Deviation from the reference, deliberate: the reference's 1-step target
uses MB.reward(bID, t) == r_t, the reward of the PREVIOUS transition
(DQN.cpp:174 with MemoryBuffer.cpp:420 indexing) — an off-by-one; here the
target uses r_{t+1}, the reward of the transition being learned.
"""
from __future__ import annotations

from typing import NamedTuple

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
from smarties_tpu.ops import discrete_policy as dpol
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters

F32 = jnp.float32


def _soft_expected_value(q_hat, q_tilde):
    """E_{pol(q_hat)}[q_tilde] with pol = Exp-normalized policy over q_hat
    (expectedValue, DQN.cpp:16-30, DQN_USE_POLICY branch)."""
    _, _, probs = dpol.probs_of(q_hat, fn="exp")
    return jnp.sum(probs * q_tilde, axis=-1)


def _greedy_expected_value(q_hat, q_tilde):
    """Qtilde[argmax Qhat] (expectedValue, DQN.cpp:36 — the reference's
    non-DQN_USE_POLICY compile branch: classic double-Q greedy boot)."""
    idx = jnp.argmax(q_hat, axis=-1)
    return jnp.take_along_axis(q_tilde, idx[..., None], axis=-1)[..., 0]


class DQN:
    presample = True   # uniform sampling hoistable out of scan bodies

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        assert mdp.is_discrete, "DQN requires discrete actions"
        self.mdp = mdp
        self.cfg = cfg
        # exploration mode (reference compile switch DQN_USE_POLICY,
        # DQN.cpp:15): default False == Boltzmann-over-Q + ReF-ER (the
        # reference's compiled default); True == the paper's eps-greedy
        # branch (annealed eps = anneal + (1-anneal)*explNoise with
        # anneal = max(0, 1 - nGradSteps*epsAnneal); acting here uses the
        # CONSTANT-eps case epsAnneal<=0 -> eps = explNoise, since acting
        # is jitted without a grad-step input; exploration-bound tasks
        # like acrobot need this mode - softmax-of-Q sharpens as |Q|
        # grows and stops exploring)
        self.eps_greedy = bool(getattr(cfg, "dqnEpsGreedy", False))
        self.n_opts = mdp.max_action_label
        self.spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
                conv=tuple(Conv2DDesc(*c) for c in mdp.conv_layers),
            n_out=self.n_opts, kind=cfg.nnType, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac,
                compute_dtype=("bfloat16" if cfg.nnBf16 else "float32"))
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        # factory default returns estimator for DQN is "none"
        # (AlgoFactory.cpp DQN branch)
        self.returns_mode = ("none" if cfg.returnsEstimator == "default"
                             else cfg.returnsEstimator)
        self.use_retrace = self.returns_mode != "none"
        self.use_target = cfg.targetDelay > 0

    # ------------------------------------------------------------------
    def init(self, key):
        net = init_params(key, self.spec)
        params = {"net": net,
                  "tgt": jax.tree_util.tree_map(jnp.copy, net)}
        return params, adam_init(net)

    def init_rnn(self, n_envs: int):
        from smarties_tpu.models.net import init_carry
        return init_carry(self.spec, (n_envs,))

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        spec = self.spec
        sample = train and self.cfg.explNoise > 0

        if self.eps_greedy:
            eps = float(self.cfg.explNoise)
            nA = self.n_opts

            def act_eps(params, obs_std, key, rnn=()):
                qs, rnn = apply_net(params["net"], spec, obs_std, rnn)
                greedy = jnp.argmax(qs, axis=-1)
                probs = (jnp.full(qs.shape, eps / nA, F32)
                         + (1.0 - eps) * jax.nn.one_hot(greedy, nA,
                                                        dtype=F32))
                opt = dpol.select(key, probs, sample)
                q_a = jnp.take_along_axis(qs, opt[..., None],
                                          axis=-1)[..., 0]
                value = _greedy_expected_value(qs, qs)
                return (opt[..., None].astype(F32), probs, value,
                        q_a - value, rnn)

            return act_eps

        def act(params, obs_std, key, rnn=()):
            qs, rnn = apply_net(params["net"], spec, obs_std, rnn)
            _, _, probs = dpol.probs_of(qs, fn="exp")
            opt = dpol.select(key, probs, sample)
            q_a = jnp.take_along_axis(qs, opt[..., None], axis=-1)[..., 0]
            value = _soft_expected_value(qs, qs)
            # appendValues(E[Q], Q[a]) => advantage = Q[a] - E[Q]
            return (opt[..., None].astype(F32), probs, value, q_a - value,
                    rnn)

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   key, axis_name=None, sample_override=None):
        """DQN::Train (DQN.cpp:150-211) as one XLA program."""
        cfg = self.cfg
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
        from smarties_tpu.algos.base import nhwc_probe_hw
        mb = gather_minibatch(rs, ep, t,
                              n_appended=self.mdp.n_appended_obs,
                              nhwc_hw=nhwc_probe_hw(self.spec, self.mdp))
        opt = mb.action[..., 0].astype(jnp.int32)

        spec = self.spec

        def fwd(p, x):
            out, _ = apply_net(p, spec, x)
            return out

        if spec.is_recurrent:
            # Truncated-BPTT window (base.py helpers; the reference gives
            # every learner recurrent nets through the same MemoryBuffer
            # window machinery, MemoryBuffer.cpp:393-402)
            xs, active = bptt_window(rs, ep, t, cfg.nnBPTTseq)
            qs, q_hat_next, pullback = seq_forward_vjp(
                params["net"], spec, xs, active)
        else:
            qs, vjp_fn = jax.vjp(lambda p: fwd(p, mb.s_t), params["net"])
            q_hat_next = fwd(params["net"], mb.s_t1)

            def pullback(g):
                return vjp_fn(g)[0]
        q_a = jnp.take_along_axis(qs, opt[:, None], axis=-1)[..., 0]

        exp_val = (_greedy_expected_value if self.eps_greedy
                   else _soft_expected_value)
        if self.use_retrace:
            td_error = mb.qret - q_a
            v_next = exp_val(q_hat_next, q_hat_next)
        else:
            if not self.use_target:
                q_tilde_next = q_hat_next
            elif spec.is_recurrent:
                q_tilde_next = seq_outputs(params["tgt"], spec,
                                           xs, active)[1]
            else:
                q_tilde_next = fwd(params["tgt"], mb.s_t1)
            # double-Q: select with online net, evaluate with target
            boot = exp_val(q_hat_next, q_tilde_next)
            target = mb.reward_next + jnp.where(
                mb.terminal_next, 0.0, cfg.gamma * boot)
            td_error = target - q_a
            v_next = exp_val(q_hat_next, q_hat_next)

        g = jax.nn.one_hot(opt, self.n_opts, dtype=F32) * td_error[:, None]

        if self.eps_greedy:
            # the reference's non-policy branch writes rho=1, dkl=0 and
            # skips ReF-ER mixing (DQN.cpp:204-205)
            rho = jnp.ones_like(td_error)
            dkl = jnp.zeros_like(td_error)
            is_far = jnp.zeros_like(rho, bool)
            grads = pullback(g)
            if axis_name is not None:
                grads = jax.lax.psum(grads, axis_name)
            new_net, new_opt = adam_step(params["net"], grads, opt_state,
                                         self.adam_cfg, 1.0 / cfg.batchSize)
            new_tgt = update_target(new_net, params["tgt"],
                                    cfg.targetDelay, new_opt.step)
            new_params = {"net": new_net, "tgt": new_tgt}
            v_val = _greedy_expected_value(qs, qs)
            rs = write_back_with_next(rs, mb, rho, dkl, td_error, v_val,
                                      q_a - v_val, v_next)
            rs, frac_off = post_step_processing(rs, cfg, new_opt.step,
                                                td_error, axis_name)
            metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                      td_error, v_val, axis_name)
            from smarties_tpu.algos.base import grad_stats
            metrics.update(grad_stats(grads))
            return new_params, new_opt, rs, metrics

        # ReF-ER on the Boltzmann policy (DQN.cpp:192-204)
        un, norm, probs = dpol.probs_of(qs, fn="exp")
        rho = dpol.imp_weight(opt, probs, mb.mu)
        dkl = dpol.kl_mu_pi(mb.mu, probs)
        if cfg.clipImpWeight > 0:
            is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
            g = jnp.where(is_far[:, None], 0.0, g)
            pen_g = dpol.kl_grad(mb.mu, qs, un, norm, probs,
                                 -jnp.ones_like(rho), fn="exp")
            g = rs.beta * g + (1 - rs.beta) * pen_g
        else:
            is_far = jnp.zeros_like(rho, bool)

        grads = pullback(g)
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)
        new_net, new_opt = adam_step(params["net"], grads, opt_state,
                                     self.adam_cfg, 1.0 / cfg.batchSize)
        new_tgt = update_target(new_net, params["tgt"], cfg.targetDelay,
                                new_opt.step)
        new_params = {"net": new_net, "tgt": new_tgt}

        v_val = _soft_expected_value(qs, qs)
        rs = write_back_with_next(rs, mb, rho, dkl, td_error, v_val,
                                  q_a - v_val, v_next)
        rs, frac_off = post_step_processing(rs, cfg, new_opt.step, td_error,
                                            axis_name)
        metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                  td_error, v_val, axis_name)
        from smarties_tpu.algos.base import grad_stats
        metrics.update(grad_stats(grads))
        return new_params, new_opt, rs, metrics

    # ------------------------------------------------------------------
    def refresh(self, rs: rb.ReplayState, n_grad_steps, axis_name=None):
        from smarties_tpu.utils.config import anneal_rate
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
