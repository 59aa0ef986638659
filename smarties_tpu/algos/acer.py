"""ACER: actor-critic with experience replay (episode windows).

JAX re-expression of the reference ACER (source/smarties/Learners/
ACER.{h,cpp}): episode-sampled training over windows of up to
SEQ_CUTOFF=200 steps; three heads over an optional shared encoder — actor
(mean + param stdev, with a target actor), V critic, and an advantage net
taking the action as input (both critics at lr x10); truncated importance
sampling with bias correction (5 on-policy expectation samples), a
trust-region projection of the policy gradient against KL(pi||pi_tgt), and
the "soft" Retrace recursion Q_RET with C = min(1,rho)^(1/sqrt(nA)).

The reference's per-window sequential loop with per-step setGradient
(ACER.cpp:16-108) becomes: batched forwards over [B, S] windows, the
backward recursions as lax.scans (they are affine in Q_RET/Q_OPC given the
forwards), analytic per-step output gradients, and one vjp per head.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.algos.base import default_metrics
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import NetSpec, apply_net, init_params
from smarties_tpu.models.optim import (AdamConfig, AdamState, adam_init,
                                       adam_step, update_target)
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.replay import buffer as rb
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32
SEQ_CUTOFF = 200           # ACER.cpp:11
N_EXPECTATION = 5          # ACER.h:24


class ACER:
    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        assert not mdp.is_discrete, "ACER implemented for continuous actions"
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        self.acer_trick_pow = 1.0 / np.sqrt(nA)   # ACER.h:22
        enc_sizes = tuple(s for s in cfg.encoderLayerSizes if s > 0)
        self.has_enc = len(enc_sizes) > 0
        feat = enc_sizes[-1] if self.has_enc else mdp.dim_net_input
        if self.has_enc:
            self.enc_spec = NetSpec(
                n_in=mdp.dim_net_input, hidden=enc_sizes[:-1],
                n_out=enc_sizes[-1], kind="FFNN", act=cfg.nnFunc,
                out_prefac=1.0, out_act=cfg.nnFunc)
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        self.actor_spec = NetSpec(
            n_in=feat, hidden=tuple(cfg.nnLayerSizes), n_out=nA,
            kind="FFNN", act=cfg.nnFunc, out_prefac=cfg.outWeightsPrefac,
            n_param_out=nA, param_init=tuple([sig0] * nA))
        self.value_spec = NetSpec(
            n_in=feat, hidden=tuple(cfg.nnLayerSizes), n_out=1,
            kind="FFNN", act=cfg.nnFunc, out_prefac=cfg.outWeightsPrefac)
        self.advtg_spec = NetSpec(
            n_in=feat + nA, hidden=tuple(cfg.nnLayerSizes), n_out=1,
            kind="FFNN", act=cfg.nnFunc, out_prefac=cfg.outWeightsPrefac)
        self.bounded = np.asarray(mdp.bounded_mask)
        self.actor_adam = AdamConfig(eta=cfg.learnrate,
                                     lambda_=cfg.nnLambda,
                                     eps_anneal=cfg.epsAnneal)
        # critics at lr x10 (ACER.cpp:200-202)
        self.critic_adam = AdamConfig(eta=10 * cfg.learnrate,
                                      lambda_=cfg.nnLambda,
                                      eps_anneal=cfg.epsAnneal)
        self.returns_mode = ("none" if cfg.returnsEstimator == "default"
                             else cfg.returnsEstimator)

    # ------------------------------------------------------------------
    def presample_fn(self, keys, rs, batch, axis_name=None):
        """Hoisted episode + window-start sampling: one vmapped batch of
        RNG draws (split + weighted choice + randint) outside the scan
        instead of one per iteration. Bit-identical key chain to the
        in-body path (fold_in by shard -> split(key, 4) -> k_ep/k_start);
        the window-start modulo by episode length is applied in-body
        where rs is current (lengths only change at commit boundaries,
        never inside a train chunk). Returns (ep [n, B], tst [n, B])."""
        from smarties_tpu.replay import buffer as _rb

        def one(k):
            if axis_name is not None:
                k = jax.random.fold_in(k, jax.lax.axis_index(axis_name))
            k_ep, k_start, _, _ = jax.random.split(k, 4)
            ep = _rb.sample_episodes(k_ep, rs, batch)
            tst = jax.random.randint(k_start, (batch,), 0, 2 ** 30)
            return ep, tst

        return jax.vmap(one)(keys)

    def init(self, key):
        ks = jax.random.split(key, 4)
        net = {"actor": init_params(ks[0], self.actor_spec),
               "value": init_params(ks[1], self.value_spec),
               "advtg": init_params(ks[2], self.advtg_spec)}
        if self.has_enc:
            net["enc"] = init_params(ks[3], self.enc_spec)
        params = {"net": net,
                  "tgt_actor": jax.tree_util.tree_map(
                      jnp.copy, net["actor"])}
        return params, adam_init(net)

    def _feat(self, net, x):
        if self.has_enc:
            y, _ = apply_net(net["enc"], self.enc_spec, x)
            return y
        return x

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        bounded = self.bounded
        sample = train and self.cfg.explNoise > 0
        nA = self.mdp.dim_action

        def act(params, obs_std, key, rnn=()):
            net = params["net"]
            feat = self._feat(net, obs_std)
            out, _ = apply_net(net["actor"], self.actor_spec, feat)
            mean, sraw = out[..., :nA], out[..., nA:]
            sigma = cp.sigma_of(sraw)
            a = cp.sample(key, mean, sigma, bounded) if sample \
                else cp.eff_mean(mean, bounded)
            mu = cp.mu_vector(mean, sigma, bounded)
            zeros = jnp.zeros(mean.shape[:-1], F32)
            return a, mu, zeros, zeros, rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   key, axis_name=None, sample_override=None):
        """ACER::Train (ACER.cpp:16-108) as one XLA program."""
        cfg = self.cfg
        nA = self.mdp.dim_action
        S = min(SEQ_CUTOFF, rs.max_len)
        n_shards = (jax.lax.psum(1, axis_name) if axis_name is not None
                    else 1)
        B = cfg.batchSize // n_shards if axis_name is not None \
            else cfg.batchSize
        if axis_name is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        k_ep, k_start, k_pol, k_extra = jax.random.split(key, 4)

        if sample_override is not None:
            ep, tst_raw = sample_override   # presample_fn: identical
            # chain, the choice/randint hoisted out of the scan body
        else:
            ep = rb.sample_episodes(k_ep, rs, B)
            tst_raw = jax.random.randint(k_start, (B,), 0, 2 ** 30)
        ndata = jnp.maximum(rs.length[ep], 1)
        tst = tst_raw % ndata
        tstart = jnp.minimum(tst, jnp.maximum(ndata - S, 0))
        tend = jnp.minimum(ndata, tstart + S)
        nsteps = tend - tstart                      # [B]

        # window gather: positions tstart+w for w in 0..S (inclusive S for
        # the bootstrap state at tend)
        w = jnp.arange(S + 1)
        tw = tstart[:, None] + w[None, :]           # [B, S+1]
        twc = jnp.minimum(tw, rs.max_len)
        active = w[None, :] < nsteps[:, None]       # [B, S+1] grad steps
        xs = (rs.states[ep[:, None], twc] - rs.state_mean) * rs.state_scale
        # ONE gather of the packed per-step record covers actions, mus,
        # rewards and the stored rho (for the incremental far-count delta
        # below) — pre-packing these were 4 separate window gathers
        rows = rs.steps[ep[:, None], twc]            # [B, S+1, R]
        ch_act, ch_mu, ch_qret, wb0, _ = rs._c
        acts = rows[..., ch_act:ch_mu]
        mus = rows[..., ch_mu:ch_qret]
        rho_old = rows[..., wb0 + 0]
        # padded window positions hold zero vectors -> mu stdev 0 would
        # produce inf/NaN inside logprob/KL before any masking can help;
        # substitute a standard-normal mu there (results are masked out)
        safe_mu = jnp.concatenate(
            [jnp.zeros((nA,), F32), jnp.ones((nA,), F32)])
        mus = jnp.where(active[..., None], mus, safe_mu)
        r_scaled = (rows[..., rb.CH_REW] - rs.rew_mean) * rs.rew_scale
        net, tgt_actor = params["net"], params["tgt_actor"]

        # behavior-independent randomness: one on-policy sample + 5
        # expectation samples per (b, s); noise drawn once, actions depend
        # on the (traced) policy means/stdevs
        noise_pol = cp.clipped_normal(k_pol, (B, S + 1, nA))
        noise_ext = cp.clipped_normal(k_extra,
                                      (N_EXPECTATION, B, S + 1, nA))

        def heads(net_p):
            feat = self._feat(net_p, xs)            # [B, S+1, F]
            pout, _ = apply_net(net_p["actor"], self.actor_spec, feat)
            vout, _ = apply_net(net_p["value"], self.value_spec, feat)
            mean, sraw = pout[..., :nA], pout[..., nA:]
            sigma = cp.sigma_of(sraw)
            # on-policy samples (stop-grad through the sampling)
            m_sg = jax.lax.stop_gradient(mean)
            s_sg = jax.lax.stop_gradient(sigma)
            pol_samp = cp.sample_with_noise(noise_pol, m_sg, s_sg,
                                            self.bounded)
            ext_samp = cp.sample_with_noise(noise_ext, m_sg[None], s_sg[None],
                                            self.bounded)

            def adv(a):
                q, _ = apply_net(net_p["advtg"], self.advtg_spec,
                                 jnp.concatenate([feat, a], axis=-1))
                return q[..., 0]

            a_taken = adv(acts)
            a_pol = adv(pol_samp)
            a_ext = jax.vmap(lambda a: adv(a))(
                jnp.broadcast_to(ext_samp, (N_EXPECTATION, B, S + 1, nA)))
            return (pout, vout[..., 0], a_taken, a_pol, a_ext, pol_samp)

        (pout, v_st, a_taken, a_pol, a_ext, pol_samp), vjp_fn = \
            jax.vjp(heads, net)
        mean, sraw = pout[..., :nA], pout[..., nA:]
        sigma = cp.sigma_of(sraw)
        tgt_out, _ = apply_net(tgt_actor, self.actor_spec,
                               self._feat(net, xs))
        tgt_mu = cp.mu_vector(tgt_out[..., :nA],
                              cp.sigma_of(tgt_out[..., nA:]), self.bounded)

        a_ext_mean = jnp.mean(a_ext, axis=0)
        q_theta = v_st + a_taken - a_ext_mean
        a_pol_c = a_pol - a_ext_mean
        # padded positions masked (mu there is the safe substitute)
        rho = jnp.where(active,
                        cp.imp_weight(acts, mean, sigma, mus, self.bounded),
                        1.0)
        dkl = jnp.where(active, cp.kl_div(mus, mean, sigma), 0.0)
        w_clip = jnp.minimum(1.0, rho)
        c_ret = w_clip ** self.acer_trick_pow

        # bootstrap at tend: Q_RET = r[tend] + gamma * V(s_tend) if not
        # terminal (ACER.cpp:57-62). Gather per-sample boundary values.
        lane = jnp.arange(B)
        idx_end = jnp.minimum(nsteps, S)
        v_end = v_st[lane, idx_end]
        r_end = r_scaled[lane, idx_end]
        # terminal only when the window reaches the episode's final state
        # (MB.isTerminal(bID, tend), ACER.cpp:57-62)
        is_term = rs.terminal[ep] & (tend == ndata)
        q_boot = r_end + jnp.where(is_term, 0.0, cfg.gamma * v_end)

        # backward recursions (affine given the forwards): scan over S
        def recur(carry, i):
            q_ret, q_opc = carry
            s = S - 1 - i
            on = active[:, s]
            q_ret_s = jnp.where(s == nsteps - 1, q_boot, q_ret)
            q_opc_s = jnp.where(s == nsteps - 1, q_boot, q_opc)
            q_ret_out, q_opc_out = q_ret_s, q_opc_s
            nq_ret = r_scaled[:, s] + cfg.gamma * (
                c_ret[:, s] * (q_ret_s - q_theta[:, s]) + v_st[:, s])
            nq_opc = r_scaled[:, s] + cfg.gamma * (
                (q_opc_s - q_theta[:, s]) + v_st[:, s])
            nq_ret = jnp.where(on, nq_ret, q_ret)
            nq_opc = jnp.where(on, nq_opc, q_opc)
            return (nq_ret, nq_opc), (q_ret_out, q_opc_out)

        (_, _), (q_rets_r, q_opcs_r) = jax.lax.scan(
            recur, (jnp.zeros(B), jnp.zeros(B)), jnp.arange(S))
        q_ret_t = jnp.flip(q_rets_r.T, axis=1)       # [B, S]
        q_opc_t = jnp.flip(q_opcs_r.T, axis=1)

        act_s = active[:, :S]
        q_err = jnp.where(act_s, q_ret_t - q_theta[:, :S], 0.0)
        a_opc = q_opc_t - v_st[:, :S]

        # policy gradient with truncated IS + bias correction
        # (ACER.cpp:78-90)
        prob_pol_mu = jnp.exp(cp.logprob_mu(pol_samp, mus, self.bounded))
        prob_pol_pi = jnp.exp(cp.logprob(pol_samp, mean, sigma,
                                         self.bounded))
        rho_pol = prob_pol_pi / jnp.maximum(prob_pol_mu, 1e-38)
        gain1 = a_opc * jnp.minimum(5.0, rho[:, :S])
        gain2 = (a_pol_c[:, :S]
                 * jnp.maximum(0.0, 1.0 - 5.0 / rho_pol[:, :S]))
        sl = lambda x: x[:, :S]
        g1m, g1s = cp.pol_grad(sl(acts), sl(mean), sl(sigma), sl(sraw),
                               gain1, self.bounded)
        g2m, g2s = cp.pol_grad(sl(pol_samp), sl(mean), sl(sigma), sl(sraw),
                               gain2, self.bounded)
        pen_m, pen_s = cp.kl_grad(sl(tgt_mu), sl(mean), sl(sigma), sl(sraw),
                                  jnp.ones_like(gain1))
        g_pol = jnp.concatenate([g1m + g2m, g1s + g2s], axis=-1)
        pen = jnp.concatenate([pen_m, pen_s], axis=-1)
        # trust-region projection (trust_region_update,
        # FunctionUtilities.h:238-255, delta == 1)
        dot = jnp.sum(g_pol * pen, axis=-1, keepdims=True)
        norm = jnp.sum(pen * pen, axis=-1, keepdims=True) + 1.19e-7
        proj = jnp.maximum(0.0, (dot - 1.0) / norm)
        g_pol = (g_pol - proj * pen) * act_s[..., None]

        # assemble per-head output gradients and pull back through vjp
        v_err = q_err * w_clip[:, :S]
        pad = lambda x: jnp.concatenate(
            [x, jnp.zeros((B, 1) + x.shape[2:], x.dtype)], axis=1)
        g_pout = pad(g_pol)
        g_v = pad(v_err + q_err)
        g_a_taken = pad(q_err)
        g_a_pol = jnp.zeros_like(a_pol)
        g_a_ext = jnp.broadcast_to(
            pad(-q_err / N_EXPECTATION)[None], a_ext.shape)
        g_pol_samp = jnp.zeros_like(pol_samp)
        grads = vjp_fn((g_pout, g_v, g_a_taken, g_a_pol, g_a_ext,
                        g_pol_samp))[0]
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)

        # split Adam: critics (value+advtg) at lr x10
        crit = {"value", "advtg"}
        n_act = {k: v for k, v in net.items() if k not in crit}
        g_act = {k: v for k, v in grads.items() if k not in crit}
        o_act = AdamState(
            m1={k: v for k, v in opt_state.m1.items() if k not in crit},
            m2={k: v for k, v in opt_state.m2.items() if k not in crit},
            beta_t_1=opt_state.beta_t_1, beta_t_2=opt_state.beta_t_2,
            step=opt_state.step)
        new_act, no_act = adam_step(n_act, g_act, o_act, self.actor_adam,
                                    1.0 / cfg.batchSize)
        n_cr = {k: net[k] for k in crit}
        g_cr = {k: grads[k] for k in crit}
        o_cr = AdamState(m1={k: opt_state.m1[k] for k in crit},
                         m2={k: opt_state.m2[k] for k in crit},
                         beta_t_1=opt_state.beta_t_1,
                         beta_t_2=opt_state.beta_t_2, step=opt_state.step)
        new_cr, no_cr = adam_step(n_cr, g_cr, o_cr, self.critic_adam,
                                  1.0 / cfg.batchSize)
        new_net = dict(new_act, **new_cr)
        new_opt = AdamState(m1=dict(no_act.m1, **no_cr.m1),
                            m2=dict(no_act.m2, **no_cr.m2),
                            beta_t_1=no_act.beta_t_1,
                            beta_t_2=no_act.beta_t_2, step=no_act.step)
        # target actor: Polyak from targetDelay (ACER.json 0.001)
        new_tgt = update_target(new_net["actor"], tgt_actor,
                                cfg.targetDelay, new_opt.step)
        new_params = {"net": new_net, "tgt_actor": new_tgt}

        # write-backs over the whole window (setMseDklImpw/setValues):
        # ONE scatter of [B, S, 5] rows into the packed trailing channel
        # slice (pre-packing: 5 window scatters)
        epw = jnp.broadcast_to(ep[:, None], (B, S))
        tww = jnp.where(act_s, twc[:, :S], rs.max_len + 1)
        # incremental far-count maintenance over the written window (the
        # stored rho rode along in the window record gather above)
        was_far = rb.is_far_policy(rho_old[:, :S],
                                   rs.cmax_ret, rs.cinv_ret) & act_s
        now_far = rb.is_far_policy(rho[:, :S], rs.cmax_ret,
                                   rs.cinv_ret) & act_s
        d_far = jnp.sum(now_far.astype(jnp.float32)
                        - was_far.astype(jnp.float32), axis=1)
        rs = rs._replace(far_count=rs.far_count.at[ep].add(d_far))
        # FULL-row window scatter: new trailing channels + the gathered
        # fixed channels re-emitted (bit-identical; partial-width
        # scatters are the slow path, replay/buffer.py layout notes)
        wrows = jnp.concatenate(
            [rows[:, :S, :wb0],
             jnp.stack([rho[:, :S], dkl[:, :S], q_err, v_st[:, :S],
                        (q_theta - v_st)[:, :S]], axis=-1),
             rows[:, :S, wb0 + 5:]], axis=-1)
        rs = rs._replace(
            steps=rs.steps.at[epw, tww].set(wrows, mode="drop"))
        from smarties_tpu.algos.base import post_step_processing
        rs, frac_off = post_step_processing(rs, cfg, new_opt.step, q_err,
                                            axis_name)
        is_far = rb.is_far_policy(rho[:, :S], rs.cmax_ret, rs.cinv_ret)
        metrics = default_metrics(dkl[:, :S], rho[:, :S], is_far, frac_off,
                                  rs.beta, q_err, v_st[:, :S], axis_name)
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
        return rs
